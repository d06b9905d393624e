"""A kernel's share of its roofline in a traced window: the least time
the card could take for the kernel's launches, over the device time the
profiler recorded for them."""
from __future__ import annotations

from portbench.costs import peaks, shapes


def kernel_share(obs, kernel: str, cost) -> float | None:
    """Percent of the bound that ``kernel``'s recorded launches reach, or
    ``None`` where no launch was recorded or its inputs fit in the L2
    cache (the HBM bound would not hold). ``cost`` is the kernel's frozen
    rule; ``obs.geometry`` gives the shapes the cell runs."""
    args = shapes.kernel_args(kernel, **obs.geometry)
    if shapes.input_bytes(args) <= peaks.L2_BYTES:
        return None
    hits = [v for name, v in obs.kernels.items() if f"{kernel}_kernel" in name]
    launches = sum(c for c, _ in hits)
    seconds = sum(s for _, s in hits)
    if not launches or seconds <= 0:
        return None
    return 100.0 * launches * peaks.bound_s(cost(*args)) / seconds
