"""``balance_scan``: the dispatcher's least-loaded walk over the sites."""
from portbench.costs.peaks import PEAK_FLOPS_F32, rule, tensor_bytes


def cost(load0, unassigned, target, home) -> dict:
    """Every input read once, the int64 sites written once; one select
    per task and one argmin over the F sites per new task. The new tasks
    are the data's count where the data can be read, and every task on
    ``meta`` inputs (the walk's longest case)."""
    B, F = load0.shape
    N = unassigned.shape[1]
    new = B * N if unassigned.is_meta else int(unassigned.sum())
    return rule(B * N + new * F,
                tensor_bytes(load0, unassigned, target, home) + B * N * 8,
                PEAK_FLOPS_F32)
