"""``evict_stats``: FELARE's per-task eviction statistics."""
from portbench.costs.peaks import PEAK_FLOPS_F32, rule, tensor_bytes


def cost(start, qfree, eet, deadline, pending, task_type) -> dict:
    """Every input read once, ``task_feas_now`` (bool) and ``min_exec``
    (float32) written once; per type and machine a sum and two minima,
    per task three comparisons."""
    B, N = deadline.shape
    S, M = eet.shape[-2:]
    return rule(B * (3 * S * M + 3 * N),
                tensor_bytes(start, qfree, eet, deadline, pending,
                             task_type) + B * N * (1 + 4),
                PEAK_FLOPS_F32)
