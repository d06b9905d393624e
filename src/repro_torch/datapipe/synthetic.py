"""Synthetic data (counterpart of ``repro/datapipe/synthetic.py``).

Two producers live here:

  * ``SyntheticLM`` / ``Prefetcher`` / ``input_specs``: the deterministic
    LM token stream of the training loop. A batch is a pure function of
    (seed, step), drawn with numpy exactly as the reference draws it, so
    both packages see the same arrays and a restarted run sees the batches
    it would have seen.
  * ``trace_stack``: the (rates x replicates) grid of scheduling traces
    for the sweep.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch


def trace_stack(seed, rates, reps, n_tasks, eet, *, cv_run: float = 0.1,
                type_probs=None, scenario=None, n_task_types=None,
                device=None):
    """The (rates x replicates) grid of traces under one seed.

    Replicate ``k`` shares its draws across rates (common random
    numbers); only the arrival process sees the rate. ``scenario`` is a
    :class:`repro_torch.scenarios.Scenario`, a registered name, or
    ``None`` for the paper's Poisson default; ``type_probs`` (S,) swaps
    its mix for a ``WeightedMix``. Leaves carry leading dims (R, K) and
    lie on ``device`` (``None`` = CUDA).
    """
    from repro_torch import scenarios as scenarios_mod

    if scenario is None:
        scenario = scenarios_mod.DEFAULT
    elif isinstance(scenario, str):
        scenario = scenarios_mod.get(scenario)
    if type_probs is not None:
        scenario = scenarios_mod.replace(
            scenario, mix=scenarios_mod.mix_from_probs(tuple(type_probs)))
    return scenario.stack(seed, rates, reps, n_tasks, eet, cv_run=cv_run,
                          n_task_types=n_task_types, device=device)


class SyntheticLM:
    """An infinite LM stream: ``batch_at(step)`` is a pure function of
    (seed, step), numpy arrays with a leading accumulation axis (A, B / A,
    ...): ``tokens`` int32, a vlm's ``patches`` and an audio model's
    ``frames`` float32. The train step moves them to its device.

    Markov-ish structure (token t+1 drifts from token t by 0-16) so that
    the loss falls in a short run instead of sitting at log V.
    """

    def __init__(self, cfg, batch: int, seq: int, *, seed: int = 0,
                 accum: int = 1):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.accum = accum

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((self.seed, step))
        V = cfg.vocab_size
        base = rng.integers(0, V, size=(self.batch, 1), dtype=np.int32)
        drift = rng.integers(0, 17, size=(self.batch, self.seq),
                             dtype=np.int32)
        toks = (base + np.cumsum(drift, axis=1)) % V
        out = {"tokens": toks.astype(np.int32)}
        if cfg.family == "vlm":
            out["patches"] = rng.standard_normal(
                (self.batch, cfg.n_patches, cfg.d_model)).astype(
                    np.float32) * 0.02
        if cfg.family == "audio":
            out["frames"] = rng.standard_normal(
                (self.batch, self.seq, cfg.d_model)).astype(
                    np.float32) * 0.02
        if self.accum > 1:
            return {k: v.reshape(self.accum, self.batch // self.accum,
                                 *v.shape[1:])
                    for k, v in out.items()}
        return {k: v[None] for k, v in out.items()}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch (depth-bounded) over any batch
    iterator."""

    def __init__(self, it, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = iter(it)
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item


def input_specs(cfg, shape, *, accum: int = 1, dtype=torch.int32) -> dict:
    """One global batch's inputs as tensors on the ``meta`` device (the
    reference's ``ShapeDtypeStruct`` stand-ins): shapes and dtypes,
    nothing allocated."""
    B, S = shape.global_batch, shape.seq_len
    mb = B // accum

    def meta(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    specs = {"tokens": meta((accum, mb, S), dtype)}
    if cfg.family == "vlm":
        specs["patches"] = meta((accum, mb, cfg.n_patches, cfg.d_model),
                                torch.bfloat16)
    if cfg.family == "audio":
        specs["frames"] = meta((accum, mb, S // 2, cfg.d_model),
                               torch.bfloat16)
        specs["tokens"] = meta((accum, mb, S // 2), dtype)
    return specs
