"""``phase1_map``: ELARE's Phase I, each task's feasible machine of least
energy."""
from portbench.costs.peaks import PEAK_FLOPS_F32, rule, tensor_bytes


def cost(avail, eet_rows, deadline, p_dyn, pending, qfree) -> dict:
    """Every input read once, ``best_m`` (int64) and ``best_ec`` (float32)
    written once; per task and machine three float32 operations (Eq. 1's
    sum, the energy product, the minimum)."""
    B, N, M = eet_rows.shape
    return rule(B * N * 3 * M,
                tensor_bytes(avail, eet_rows, deadline, p_dyn, pending,
                             qfree) + B * N * (8 + 4),
                PEAK_FLOPS_F32)
