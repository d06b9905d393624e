"""Wall milliseconds per loop iteration of the measured window, untraced:
its host time over the iterations ``engine.COUNTS`` counted in its
batches (each batch's trace generation, set-up and copy back included)."""


def read(obs):
    if not obs.window_iters:
        return None
    return obs.window_s * 1e3 / obs.window_iters
