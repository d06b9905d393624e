"""FLOP and HBM-byte accounting by walking the ops a function runs
(counterpart of ``repro/roofline/jaxpr_cost.py``).

:func:`cost` runs ``fn`` under :class:`~repro_torch.roofline.walk.Walker`
and sums a per-op model, the reference's ``_visit_cost``:

  * ``mm``, ``bmm``, ``addmm``, ``baddbmm`` (what ``linear``, ``matmul``
    and ``einsum`` become): 2 batch m n k FLOPs, all of them
    ``matmul_flops``; inputs plus output in bytes;
  * ``convolution``: 2 FLOPs per output element and kernel tap;
    inputs plus output in bytes;
  * ``gather``, ``index_select``, ``embedding``, ``index``: twice the
    output's bytes (the region read, the output written), one FLOP per
    output element;
  * ``index_put_``, ``scatter*``, ``index_copy_``, ``index_add_`` and
    ``copy_`` (into a slice or whole): twice the update's bytes (a
    read-modify-write of the touched region, not of the whole operand),
    one FLOP per updated element;
  * collectives (``_c10d_functional.*``, ``c10d.*``): no FLOP and no
    byte here; :mod:`~repro_torch.roofline.collectives` counts their
    bytes;
  * anything else: one FLOP per output element and the output's bytes
    once (the reference's fused producer-to-consumer estimate).

One difference from the reference, deliberately: views (``view``,
``reshape`` where it is a view, ``transpose``, ``expand``, ``slice``,
``select``, ``as_strided``, ...) move no bytes and count nothing. The
reference counts a reshape's output once; here a reshape that copies
reaches the dispatcher as a ``clone`` or ``_unsafe_view`` of a copy and is
counted as that copy.

A hand-written kernel's scope counts its rule instead of the ops inside
(``by_kernel``). The count includes the backward when ``fn`` calls
``backward()`` or ``autograd.grad``, and the recomputation of per-block
remat, since both run their ops. Counts are per rank: a ``DTensor`` is
counted by its local shard, the work this rank does.
"""
from __future__ import annotations

import math

import torch

from repro_torch.roofline import hw
from repro_torch.roofline.collectives import CollectiveCounter
from repro_torch.roofline.walk import Walker, nbytes, tensors

_MATMULS = {"mm", "bmm", "addmm", "baddbmm"}
_GATHERS = {"gather", "index_select", "embedding", "index"}
#: updates of a region: the name and the argument holding the update (a
#: scalar there: the index before it gives the region)
_UPDATES = {"index_put_": 2, "index_put": 2, "_index_put_impl_": 2,
            "scatter_": 3, "scatter": 3, "scatter_add_": 3,
            "scatter_add": 3, "scatter_reduce_": 3, "scatter_reduce": 3,
            "index_copy_": 3, "index_copy": 3, "index_add_": 3,
            "index_add": 3}
#: allocation, aliasing and host reads: no FLOP and no byte
_FREE = {"empty", "empty_like", "empty_strided", "detach", "lift_fresh",
         "_unsafe_view", "alias", "_local_scalar_dense"}


def dot_flops(a_shape, b_shape) -> int:
    """2 batch m n k of ``a @ b``: a (..., m, k), b (..., k, n) or (k,)."""
    k = a_shape[-1]
    m = a_shape[-2] if len(a_shape) >= 2 else 1
    n = b_shape[-1] if len(b_shape) >= 2 else 1
    batch = math.prod(a_shape[:-2]) if len(a_shape) > 2 else 1
    return 2 * batch * m * n * k


def op_cost(op) -> tuple:
    """(flops, bytes, matmul_flops) of one :class:`~walk.Op`."""
    name = op.name
    if op.is_view or name in _FREE or op.namespace in ("_c10d_functional",
                                                       "c10d"):
        return 0, 0, 0
    outs = tensors(op.out)
    out_b = sum(nbytes(t) for t in outs)
    out_e = sum(t.numel() for t in outs)
    args = op.args
    if name in _MATMULS:
        a, b = args[1:3] if name.startswith("add") else args[:2]
        f = dot_flops(tuple(a.shape), tuple(b.shape))
        return f, sum(nbytes(t) for t in tensors(args)) + out_b, f
    if name == "convolution":       # weight (O, I / groups, *taps)
        taps = math.prod(args[1].shape[1:])
        return (2 * out_e * taps,
                sum(nbytes(t) for t in tensors(args)) + out_b, 0)
    if name in _GATHERS:
        return out_e, 2 * out_b, 0
    if name in _UPDATES:
        i = _UPDATES[name]
        upd = args[i]
        if not isinstance(upd, torch.Tensor):    # a scalar written
            n = args[i - 1].numel()
            return n, 2 * n * args[0].element_size(), 0
        return upd.numel(), 2 * nbytes(upd), 0
    if name == "copy_":
        dst = args[0]
        return dst.numel(), 2 * nbytes(dst), 0
    return out_e, out_b, 0


class CostCounter:
    """The walker's two visitors summing :func:`op_cost` and the kernels'
    rules; ``result()`` is :func:`cost`'s dict."""

    def __init__(self):
        self.flops = self.bytes = self.matmul_flops = 0
        self.by_kernel: dict = {}
        self.coll = CollectiveCounter()

    def visit(self, op) -> None:
        self.coll.visit(op)
        f, b, mf = op_cost(op)
        self.flops += f
        self.bytes += b
        self.matmul_flops += mf

    def kernel_visit(self, name, c, _path) -> None:
        self.flops += c["flops"]
        self.bytes += c["bytes"]
        self.matmul_flops += c["matmul_flops"]
        k = self.by_kernel.setdefault(name, {"calls": 0, "flops": 0,
                                             "bytes": 0, "matmul_flops": 0,
                                             "comp_seconds": 0.0,
                                             "bound_seconds": 0.0})
        k["calls"] += 1
        for key in ("flops", "bytes", "matmul_flops"):
            k[key] += c[key]
        k["comp_seconds"] += c["flops"] / c["rate"]
        k["bound_seconds"] += bound_seconds(c)

    def result(self, walker) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "matmul_flops": self.matmul_flops,
                "by_kernel": self.by_kernel,
                "collectives": self.coll.by_kind,
                "peak_bytes": walker.peak_bytes,
                "findings": [f.row() for f in walker.findings]}


def bound_seconds(c: dict) -> float:
    """A kernel rule's least time: the larger of its bytes over HBM and
    its FLOPs over the rule's ``rate``."""
    return max(c["bytes"] / hw.HBM_BW, c["flops"] / c["rate"])


class WalkError(RuntimeError):
    """``fn`` raised under the walker; ``findings`` holds the ops that
    raised, with their paths (``walk.Finding.row``)."""

    def __init__(self, msg: str, findings: list):
        super().__init__(msg)
        self.findings = findings


def measure(fn, *args, **kwargs) -> tuple:
    """``(fn(*args, **kwargs), its cost)``: :func:`cost` that keeps the
    result. Raises :class:`WalkError` (from the error) if ``fn`` raises."""
    c = CostCounter()
    w = Walker(c.visit, c.kernel_visit)
    try:
        with w:
            out = fn(*args, **kwargs)
    except Exception as e:
        raise WalkError(f"{type(e).__name__}: {e}",
                        [f.row() for f in w.findings]) from e
    return out, c.result(w)


def cost(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` under the walker: ``{flops, bytes,
    matmul_flops, by_kernel, collectives, peak_bytes, findings}``, per
    rank. ``peak_bytes`` is the most the ops' own allocations held at
    once (the arguments not included). ``by_kernel``: per kernel its
    calls, its rule's flops, bytes and matmul_flops, and summed over the
    calls the seconds of its FLOPs at its rule's rate (``comp_seconds``)
    and of its bound (``bound_seconds``). ``collectives``: bytes by kind."""
    return measure(fn, *args, **kwargs)[1]
