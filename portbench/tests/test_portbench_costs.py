"""The frozen cost rules equal the port's own rules at a few shapes, on
``meta`` tensors (the shapes the cells run) and on real ones."""
import pytest
import torch

import portbench_common  # noqa: F401  (puts the port on the path)
from portbench.costs import (balance_scan, evict_stats, map_decide, peaks,
                             phase1_map, shapes)
from repro_torch.kernels.map_fused import ops as map_ops
from repro_torch.kernels.phase1_map import ops as p1_ops

RULES = {
    "map_decide": (map_decide.cost, map_ops.map_decide_cost),
    "evict_stats": (evict_stats.cost, map_ops.evict_stats_cost),
    "phase1_map": (phase1_map.cost, p1_ops.phase1_map_cost),
    "balance_scan": (balance_scan.cost, map_ops.balance_scan_cost),
}
GEOMETRIES = [dict(B=40960, N=400, M=4, S=4, F=1),
              dict(B=20480, N=800, M=32, S=4, F=8),
              dict(B=3, N=17, M=6, S=5, F=1),
              dict(B=5, N=33, M=8, S=3, F=2)]


@pytest.mark.parametrize("kernel", sorted(RULES))
@pytest.mark.parametrize("geo", GEOMETRIES, ids=lambda g: "x".join(
    str(v) for v in g.values()))
def test_frozen_rule_equals_the_port(kernel, geo):
    ours, theirs = RULES[kernel]
    args = shapes.kernel_args(kernel, **geo)
    want = theirs(*args)
    got = ours(*args)
    assert got["flops"] == want["flops"]
    assert got["bytes"] == want["bytes"]
    assert got["rate"] == want["rate"] == peaks.PEAK_FLOPS_F32


def test_balance_scan_counts_the_new_tasks_on_real_inputs():
    load0 = torch.zeros((2, 4), dtype=torch.int64)
    unassigned = torch.tensor([[1, 0, 1], [0, 0, 1]], dtype=torch.bool)
    target = torch.zeros_like(unassigned)
    home = torch.zeros((2, 3), dtype=torch.int64)
    got = balance_scan.cost(load0, unassigned, target, home)
    assert got == {k: v for k, v in map_ops.balance_scan_cost(
        load0, unassigned, target, home).items() if k in got}
    assert got["flops"] == 2 * 3 + 3 * 4


def test_the_cells_kernels_exceed_l2():
    """At the cells' sizes every kernel's inputs are well over twice the L2
    cache, so every share is held to HBM."""
    for geo, kernels in ((GEOMETRIES[0], ("map_decide", "evict_stats",
                                          "phase1_map")),
                         (GEOMETRIES[1], ("map_decide", "evict_stats",
                                          "balance_scan"))):
        for k in kernels:
            nbytes = shapes.input_bytes(shapes.kernel_args(k, **geo))
            assert nbytes > 2 * peaks.L2_BYTES, (k, nbytes)
