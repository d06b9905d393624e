"""Expected Execution Time (EET) tables, their lookups, and actual-runtime
sampling.

Counterpart of ``repro/core/eet.py``: the paper's Table I, the Sec. VI-A
power profiles and the AWS scenario tables, copied so that the port
imports nothing of the JAX package, and the CVB synthesis of EET tables
(:func:`cvb_eet`). Randomness comes from a ``numpy.random.Generator``; it
cannot reproduce JAX's threefry streams, so sampling is held to the
reference in distribution only (:func:`cvb_from_draws`, fed the
reference's draws, gives its table).

A table on the device is shared by a batch, (S, M), or given per row,
(B, S, M), as the engine does for the federation's site views;
:func:`type_rows` and :func:`eet_at` read both.
"""
from __future__ import annotations

import numpy as np
import torch

# --- Table I of the paper (4 task types x 4 machine types, seconds) ---------
TABLE_I = np.array(
    [
        [2.238, 1.696, 4.359, 0.736],
        [2.256, 1.828, 4.377, 0.868],
        [2.076, 1.531, 5.096, 0.865],
        [2.092, 1.622, 4.388, 0.913],
    ],
    dtype=np.float32,
)

# Machine power profiles from Sec. VI-A, in units of the unit power ``p``.
P_DYN = np.array([1.6, 3.0, 1.8, 1.5], dtype=np.float32)
P_IDLE = np.full(4, 0.05, dtype=np.float32)

# --- AWS scenario (Sec. VI-A, scenario i) ------------------------------------
# Rows: face recognition, speech recognition. Cols: t2.xlarge (CPU),
# g3s.xlarge (GPU). Mean end-to-end inference latencies (s); powers are
# the TDPs quoted in the paper (120 W, 300 W).
AWS_EET = np.array(
    [
        [0.570, 0.270],
        [3.380, 0.980],
    ],
    dtype=np.float32,
)
AWS_P_DYN = np.array([120.0, 300.0], dtype=np.float32)
AWS_P_IDLE = np.array([6.0, 15.0], dtype=np.float32)


def cvb_from_draws(g_task, g_mach, mean_task=3.0, cv_task=0.6,
                   cv_mach=0.6) -> np.ndarray:
    """The CVB transform of standard Gamma draws, in float32: ``g_task``
    (S,) of shape ``1/cv_task^2`` gives the per-type baselines ``q_i =
    g_task * mean_task cv_task^2``, and ``g_mach`` (S, M) of shape
    ``1/cv_mach^2`` the rows ``g_mach * q_i cv_mach^2``."""
    f32 = np.float32
    q = np.asarray(g_task, f32) * f32(mean_task * cv_task**2)
    return (np.asarray(g_mach, f32)
            * (q[:, None] * f32(cv_mach**2))).astype(f32)


def cvb_eet(rng: np.random.Generator, n_task_types, n_machines,
            mean_task=3.0, cv_task=0.6, cv_mach=0.6) -> np.ndarray:
    """Coefficient-of-Variation-Based EET synthesis [38]: a per-type
    baseline q_i ~ Gamma with mean ``mean_task`` and CV ``cv_task``, then
    row i drawn from a Gamma with mean q_i and CV ``cv_mach``. The CVs set
    the task and machine heterogeneity. Returns (S, M) float32."""
    f32 = np.float32
    g_task = rng.standard_gamma(1.0 / cv_task**2, n_task_types, dtype=f32)
    g_mach = rng.standard_gamma(1.0 / cv_mach**2, (n_task_types, n_machines),
                                dtype=f32)
    return cvb_from_draws(g_task, g_mach, mean_task, cv_task, cv_mach)


def sample_actual_exec(rng: np.random.Generator, eet, task_type,
                       cv_run: float = 0.1) -> np.ndarray:
    """Per-task actual runtimes on every machine, as float32 (N, M).

    Runtime of task k (type i) on machine j ~ Gamma with mean EET[i, j]
    and CV ``cv_run``: shape ``1/cv^2``, scale ``EET * cv^2``.
    """
    eet = np.asarray(eet, np.float32)
    means = eet[np.asarray(task_type)]                       # (N, M)
    shape = 1.0 / cv_run**2
    draw = rng.standard_gamma(shape, means.shape, dtype=np.float32)
    return (draw * (means * np.float32(cv_run**2))).astype(np.float32)


def _row_index(eet, idx):
    """(B, 1, ...) row numbers of a per-row table, shaped to broadcast
    against ``idx`` (B, ...)."""
    return torch.arange(eet.shape[0], device=eet.device).reshape(
        (-1,) + (1,) * (idx.dim() - 1))


def type_rows(eet, task_type):
    """(B, ..., M) EET row of each task's type: ``eet[task_type]`` of the
    shared (S, M) table, or ``eet[b, task_type[b, ...]]`` of per-row
    (B, S, M) tables. ``task_type`` is (B, ...)."""
    if eet.dim() == 2:
        return eet[task_type]
    return eet[_row_index(eet, task_type), task_type]


def eet_at(eet, task_type, machine):
    """``eet[task_type, machine]`` of the shared table, or ``eet[b,
    task_type, machine]`` of per-row tables; the indices broadcast and
    lead with B."""
    if eet.dim() == 2:
        return eet[task_type, machine]
    return eet[_row_index(eet, task_type), task_type, machine]
