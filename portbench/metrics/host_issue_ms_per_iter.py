"""Host milliseconds to issue one loop iteration with nothing holding the
host back: the program's always-on counters, ``engine.COUNTS["issue_ns"]``
over ``["issue_iters"]``, the check iterations, where the periodic check
has just emptied the launch queue. Read over the process's untraced
simulations: the warm-up's (two check iterations) and the measured
window's batches; the traced simulation counts into the copy of
``COUNTS`` that the harness swaps in, so it stays out. ``None`` where the
program keeps no such counters."""
import sys


def read(obs):
    engine = sys.modules.get("repro_torch.core.engine")
    counts = getattr(engine, "COUNTS", {})
    if not counts.get("issue_iters"):
        return None
    return counts["issue_ns"] * 1e-6 / counts["issue_iters"]
