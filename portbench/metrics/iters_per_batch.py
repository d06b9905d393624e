"""Loop iterations of the window's first batch, from ``engine.COUNTS``:
fixed for a seed, so a change that merges events shows here."""


def read(obs):
    return obs.batch_iters or None
