"""Percent of the traced window in which no device operation ran (the
union of the profiler's device records against the window's host
time)."""


def read(obs):
    if obs.busy_s <= 0 or obs.trace_wall_s <= 0:
        return None
    return 100.0 * (1.0 - obs.busy_s / obs.trace_wall_s)
