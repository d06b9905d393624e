"""``map_decide``: the fused Phase I / Phase II pass of the map stage."""
from portbench.costs.peaks import PEAK_FLOPS_F32, rule, tensor_bytes


def cost(now, start, p_dyn, qfree, eet, deadline, pending, task_type,
         suffered_task) -> dict:
    """Every input read once, the five outputs written once; per task and
    machine four operations (the EET gather, Eq. 1's sum, Eq. 2's
    product, the feasibility test) and per task two (the drop rule and
    the Phase-II key)."""
    B, N = deadline.shape
    M = eet.shape[-1]
    outs = B * N + 2 * B * M * (4 + 8)          # drop; (key f32, task i64)
    return rule(B * N * (4 * M + 2),
                tensor_bytes(now, start, p_dyn, qfree, eet, deadline,
                             pending, task_type, suffered_task) + outs,
                PEAK_FLOPS_F32)
