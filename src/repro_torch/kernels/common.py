"""What every kernel wrapper of the port shares: the CPU/CUDA split and the
argument checks done before a pointer reaches native code."""
from __future__ import annotations

import ctypes

import torch

def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU: the wrapper then runs its
    plain PyTorch version. Anything else must be one CUDA device."""
    return all(t.device.type == "cpu" for t in tensors)


def refuse_autograd(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would record this call: grad mode is on and an
    input requires grad. The CUDA kernels have no backward (the JAX
    package's Pallas kernels have none either), and on the card their
    output would leave the graph, so the wrapper refuses on every device,
    the CPU included, rather than return a result whose gradient is
    silently wrong."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the kernel has no backward pass (nor have the JAX "
            f"package's Pallas kernels); train with attn_impl=\"plain\" and "
            f"ssm_impl=\"plain\", or call it under torch.no_grad()")


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> int:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``; return its data pointer."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def cuda_device(t: torch.Tensor) -> torch.device:
    """The CUDA device of ``t``; raises for any other device."""
    if t.device.type != "cuda":
        raise ValueError(f"kernel inputs must all lie on the CPU or all on "
                         f"one CUDA device, got {t.device}")
    return t.device


def stream_ptr(device: torch.device) -> int:
    """The current PyTorch stream of ``device``, as a pointer."""
    return torch.cuda.current_stream(device).cuda_stream


def raise_on(rc: int, kernel: str) -> None:
    """Raise when a launch reported a CUDA error (``cudaGetLastError``)."""
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {rc}")


#: The element dtypes the model kernels take, by their code in the C
#: interfaces.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: ctypes argument types: a pointer (device address or stream), an int and
#: a 64-bit int (element strides).
PTR = ctypes.c_void_p
INT = ctypes.c_int
LL = ctypes.c_longlong


def tensor_bytes(*tensors) -> int:
    """Bytes of the tensors' elements (``None`` entries skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def rule(flops: int, nbytes: int, rate: float, matmul_flops: int = 0) -> dict:
    """A kernel's cost as the roofline walker counts it: the work the
    function defines, whatever implements it. ``nbytes``: each input read
    once, each output written once; ``rate``: the peak FLOP/s that
    applies to its operations."""
    return {"flops": int(flops), "bytes": int(nbytes), "rate": float(rate),
            "matmul_flops": int(matmul_flops)}


def empty_meta(shape, dtype: torch.dtype) -> torch.Tensor:
    """An empty ``meta`` tensor: what a wrapper returns for ``meta`` inputs
    while the roofline walker is active."""
    return torch.empty(shape, dtype=dtype, device="meta")
