"""Published peaks of one NVIDIA H100 80GB HBM3 (SXM) at its full power
limit of 700 W, dense, from NVIDIA's data sheet."""

#: float32 outside the tensor cores (the CUDA cores' FMA), FLOP/s.
PEAK_FLOPS_F32 = 67e12
#: HBM3, bytes/s.
HBM_BW = 3.35e12
#: Last-level cache: a kernel whose inputs fit in it is not held to HBM.
L2_BYTES = 50 * 1024 * 1024


def tensor_bytes(*tensors) -> int:
    """Bytes of the tensors' elements (``None`` entries skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def rule(flops: int, nbytes: int, rate: float) -> dict:
    """A kernel's cost: the work the function defines, whatever implements
    it. ``nbytes``: each input read once, each output written once."""
    return {"flops": int(flops), "bytes": int(nbytes), "rate": float(rate)}


def bound_s(cost: dict) -> float:
    """The least time the card could take: the larger of bytes over HBM
    bandwidth and operations over the peak rate."""
    return max(cost["bytes"] / HBM_BW, cost["flops"] / cost["rate"])
