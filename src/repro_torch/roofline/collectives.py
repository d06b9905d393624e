"""Collective bytes per rank, by kind (counterpart of
``repro/roofline/hlo_graph.collective_bytes_weighted`` and
``repro/roofline/analysis.collective_bytes``).

The reference parses the compiled HLO and weights a ``while`` body by
its trip count. The port sees each collective as it runs, so every trip
counts and no weighting is needed. It counts both routes the port uses:

  * the functional collectives (``_c10d_functional.*``) behind
    ``DTensor.full_tensor()`` and ``redistribute`` (``sharding.gather``,
    ``to_rows``, ``from_rows``);
  * the c10d ops behind ``dist.all_reduce`` and ``dist.all_gather``
    (``sharding.all_reduce_mesh`` and ``_GatherRows``).

As in the reference, the size counted is the result's: the reduced
tensor for an all-reduce, the gathered one for an all-gather, the shard
for a reduce-scatter (what crossed the links, up to a ring factor).
"""
from __future__ import annotations

from repro_torch.roofline.walk import Walker, nbytes, tensors

#: op name -> (kind, which argument holds the result; None: the output)
_FUNCTIONAL = {
    "all_gather_into_tensor": ("all-gather", None),
    "all_reduce": ("all-reduce", None),
    "all_reduce_": ("all-reduce", None),
    "reduce_scatter_tensor": ("reduce-scatter", None),
    "all_to_all_single": ("all-to-all", None),
    "broadcast": ("broadcast", None),
    "broadcast_": ("broadcast", None),
}
_C10D = {
    "allreduce_": ("all-reduce", 0),
    "allgather_": ("all-gather", 0),
    "_allgather_base_": ("all-gather", 0),
    "reduce_scatter_": ("reduce-scatter", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 0),
    "alltoall_": ("all-to-all", 0),
    "alltoall_base_": ("all-to-all", 0),
    "send": ("send/recv", 0),
    "recv_": ("send/recv", 0),
    "broadcast_": ("broadcast", 0),
}


def collective_of(op):
    """(kind, bytes of its result) for a collective op, else None."""
    table = {"_c10d_functional": _FUNCTIONAL, "c10d": _C10D}.get(
        op.namespace)
    if table is None or op.name not in table:
        return None
    kind, arg = table[op.name]
    held = op.out if arg is None else op.args[arg]
    return kind, sum(nbytes(t) for t in tensors(held))


class CollectiveCounter:
    """A walker visitor summing :func:`collective_of` by kind."""

    def __init__(self):
        self.by_kind: dict = {}

    def visit(self, op) -> None:
        got = collective_of(op)
        if got is not None:
            kind, b = got
            self.by_kind[kind] = self.by_kind.get(kind, 0) + b


def collective_bytes(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` under the walker: ``{kind: bytes}`` of
    the collectives this rank ran (the kernel scopes hold none)."""
    c = CollectiveCounter()
    with Walker(c.visit):
        fn(*args, **kwargs)
    return c.by_kind
