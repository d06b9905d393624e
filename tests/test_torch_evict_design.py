"""The ``evict_stats`` CUDA kernel's design, emulated on the CPU and held
against the plain version and the JAX package's Pallas kernel; and the
port's int32 task types, which that kernel and ``map_decide`` read.

The kernel (``csrc/map_fused.cu``) runs only on the card. This file
replays its design, with the constants read from the source:

- both outputs depend on a task only through (type, deadline, pending), so
  each block first builds its row's per-type tables, one warp per type
  with lane l taking machines l, l + 32, ... and an xor-shuffle reduction
  across the lanes (+inf the minima's identity): ``min_exec[s]``, the
  fminf over the machines, ``reach[s]``, the fminf over the free machines
  of ``start[m] + e[s][m]`` (each sum one float32 rounding), and the flag
  ``any_free[s]``; then ``feas = pending && any_free[type] && reach[type]
  <= d``, with no loop over machines per task;
- a row's tasks go in groups of 4 from its first 16-byte boundary (flat
  index a multiple of 4) to its last, the rest one by one; group q (and
  the k-th single task before or after the groups) to thread q mod
  (split x EVICT_THREADS) of the row's ``split`` blocks, where split is
  as many blocks as give EVICT_BLOCKS_PER_SM per SM of the card (132 on
  an H100 SXM), but no more than the row's groups fill with one per
  thread.

It must equal ``evict_stats_plain`` and the Pallas kernel (interpret mode)
for M in {1, 3, 4, 20}, shared and per-row tables (with BIG columns, as
the masked fold has them), rows with no free machine, deadlines equal to
``start + e`` and deadlines of +inf.
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.map_fused import evict_stats as jax_evict_stats
from repro_torch import interop, scenarios
from repro_torch.core import engine as tengine
from repro_torch.core.equations import BIG
from repro_torch.kernels import map_fused
from repro_torch.kernels.map_fused import ops as mf
from repro_torch.scenarios.base import split_seed
from test_torch_common import CPU, SPEC, TSPEC, jax_trace, stack_traces
from test_torch_kernels_cuda import kernel_inputs

SOURCE = (pathlib.Path(mf.__file__).resolve().parents[1] / "csrc"
          / "map_fused.cu").read_text()
EVICT_THREADS = int(re.search(r"constexpr int EVICT_THREADS = (\d+);",
                              SOURCE).group(1))
EVICT_BLOCKS_PER_SM = int(re.search(
    r"constexpr int EVICT_BLOCKS_PER_SM = (\d+);", SOURCE).group(1))
H100_SMS = 132
WARP = 32


def split_of(B: int, N: int, n_sm: int = H100_SMS) -> int:
    want = -(-EVICT_BLOCKS_PER_SM * n_sm // B)
    most = -(-(-(-N // 4)) // EVICT_THREADS)
    return min(want, most)


def work_items(B: int, N: int, b: int, vec: bool = True):
    """Row b's work as the kernel deals it: ``(first task, width, owner)``
    for every single task and group of 4, owner = block part x threads +
    thread."""
    base, end = b * N, b * N + N
    a0 = min(-(-base // 4) * 4, end) if vec else end
    a1 = max(a0, end // 4 * 4) if vec else end
    stride = split_of(B, N) * EVICT_THREADS
    items = [(k, 1, k % stride) for k in range(a0 - base)]
    items += [(a0 - base + 4 * q, 4, q % stride)
              for q in range((a1 - a0) // 4)]
    items += [(a1 - base + k, 1, k % stride) for k in range(end - a1)]
    return items


def type_tables(start, qfree, eet):
    """One row's (min_exec, reach, any_free) per type, as a warp per type
    computes them: each lane over its machines, then the xor butterfly."""
    S, M = eet.shape
    lanes = np.arange(WARP)
    mn = np.full((S, WARP), np.inf, np.float32)
    reach = np.full((S, WARP), np.inf, np.float32)
    any_lane = np.zeros((S, WARP), bool)
    for m0 in range(0, M, WARP):
        m = m0 + lanes
        ok = m < M
        e = np.where(ok, eet[:, np.minimum(m, M - 1)], np.float32(np.inf))
        mn = np.fmin(mn, e)
        free = ok & qfree[np.minimum(m, M - 1)]
        c = (start[np.minimum(m, M - 1)] + e).astype(np.float32)
        reach = np.where(free, np.fmin(reach, c), reach)
        any_lane |= free
    for off in (16, 8, 4, 2, 1):
        mn = np.fmin(mn, mn[:, lanes ^ off])
        reach = np.fmin(reach, reach[:, lanes ^ off])
    assert (mn == mn[:, :1]).all() and (reach == reach[:, :1]).all()
    return mn[:, 0], reach[:, 0], any_lane.any(axis=1)


def emulate(start, qfree, eet, deadline, pending, task_type, vec=True):
    B, N = deadline.shape
    feas = np.zeros((B, N), bool)
    min_exec = np.zeros((B, N), np.float32)
    written = np.zeros((B, N), np.int64)
    for b in range(B):
        mn, reach, any_free = type_tables(start[b], qfree[b],
                                          eet if eet.ndim == 2 else eet[b])
        for k, width, _ in work_items(B, N, b, vec):
            sl = slice(k, k + width)
            y = task_type[b, sl]
            feas[b, sl] = pending[b, sl] & any_free[y] & (
                reach[y] <= deadline[b, sl])
            min_exec[b, sl] = mn[y]
            written[b, sl] += 1
    assert (written == 1).all()
    return feas, min_exec


def evict_case(B, N, M, S, per_row, seed):
    """kernel_inputs with the edges: row 0 without a free machine, some
    deadlines exactly start + e of a free machine, some +inf (also on row
    0), and per-row tables whose last columns read BIG."""
    x = kernel_inputs(B, N, M, S, seed=seed)
    r = np.random.default_rng(seed + 100)
    x["qfree"][0] = False
    if per_row:
        eet = np.round(r.uniform(0.5, 5.0, (B, S, M)) * 8) / 8
        if M > 2:
            eet[:, :, M - 2:] = BIG
        x["eet"] = eet.astype(np.float32)
    e = x["eet"] if per_row else np.broadcast_to(x["eet"], (B, S, M))
    rows = np.arange(B)[:, None]
    m = r.integers(0, M, (B, N))
    exact = (x["start"][rows, m] + e[rows, x["task_type"], m]).astype(
        np.float32)
    pick = r.random((B, N))
    x["deadline"] = np.where(pick < 0.3, exact, x["deadline"])
    x["deadline"] = np.where(pick > 0.9, np.float32(np.inf),
                             x["deadline"]).astype(np.float32)
    return x


def args_of(x, as_torch=False):
    a = (x["start"], x["qfree"], x["eet"], x["deadline"], x["pending"],
         x["task_type"])
    return tuple(torch.as_tensor(v) for v in a) if as_torch else a


def test_constants_and_split():
    assert (EVICT_THREADS, EVICT_BLOCKS_PER_SM) == (256, 4)
    # flat (150 x 2000), paper_x8's block fold (1200 x 4000), tiered_x4's
    # masked fold (80 x 2000), and rows too short to split
    assert [split_of(150, 2000), split_of(1200, 4000), split_of(80, 2000),
            split_of(3, 1001), split_of(3, 7)] == [2, 1, 2, 1, 1]


@pytest.mark.parametrize("B,N", [(3, 1001), (150, 2000), (7, 13), (2, 3)])
def test_work_covers_every_task_once(B, N):
    for b in range(B):
        for vec in (True, False):
            seen = np.zeros(N, np.int64)
            for k, width, owner in work_items(B, N, b, vec):
                seen[k:k + width] += 1
                assert owner < split_of(B, N) * EVICT_THREADS
                assert width == 1 or (b * N + k) % 4 == 0
            assert (seen == 1).all()


def test_task_type_is_int32_in_the_kernel_inputs():
    assert kernel_inputs(2, 5, 3, 4)["task_type"].dtype == np.int32


@pytest.mark.parametrize("per_row", [False, True], ids=["shared", "per_row"])
@pytest.mark.parametrize("M", [1, 3, 4, 20, 37])
def test_tables_equal_plain(M, per_row):
    """Up to 37 machines: a lane then takes two."""
    x = evict_case(6, 1001, M, 4, per_row, seed=M)
    assert np.isinf(x["deadline"]).any() and not x["qfree"][0].any()
    want = mf.evict_stats_plain(*args_of(x, as_torch=True))
    for vec in (True, False):
        got = emulate(*args_of(x), vec=vec)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy(), err_msg=str(vec))


@pytest.mark.parametrize("per_row", [False, True], ids=["shared", "per_row"])
@pytest.mark.parametrize("M", [1, 3, 4, 20])
def test_tables_equal_pallas(M, per_row):
    x = evict_case(3, 131, M, 4, per_row, seed=M + 7)
    feas, min_exec = emulate(*args_of(x))
    for b in range(3):
        rf, rm = jax_evict_stats(
            jnp.asarray(x["start"][b]), jnp.asarray(x["qfree"][b]),
            jnp.asarray(x["eet"][b] if per_row else x["eet"]),
            jnp.asarray(x["deadline"][b]), jnp.asarray(x["pending"][b]),
            jnp.asarray(x["task_type"][b]), interpret=True)
        np.testing.assert_array_equal(feas[b], np.asarray(rf))
        np.testing.assert_array_equal(min_exec[b], np.asarray(rm))


def test_no_free_machine_is_infeasible_at_any_deadline():
    """any_free is its own flag: a pending task with d = +inf and no free
    machine is not feasible, though an infinite reach would be <= d."""
    x = evict_case(2, 64, 4, 4, False, seed=5)
    x["qfree"][:] = False
    x["pending"][:] = True
    x["deadline"][:] = np.inf
    feas, _ = emulate(*args_of(x))
    assert not feas.any()
    assert not mf.evict_stats_plain(*args_of(x, as_torch=True))[0].any()


def test_wrappers_take_int32_types_on_cpu():
    """On the CPU the wrappers run the plain versions on int32 types, and
    agree with int64 ones, counting no launch."""
    x = evict_case(4, 203, 4, 4, False, seed=3)
    t = args_of(x, as_torch=True)
    before = dict(mf.LAUNCHES)
    got = map_fused.evict_stats(*t)
    wide = map_fused.evict_stats(*t[:5], t[5].to(torch.int64))
    assert t[5].dtype == torch.int32 and mf.LAUNCHES == before
    for g, w in zip(got, wide):
        assert torch.equal(g, w)


# --------------------------------------------------------------------------
# int32 task types in the port
# --------------------------------------------------------------------------
def test_synthesis_draws_the_same_types_as_int32():
    """Native synthesis draws the types as int64, as it always did, and
    keeps them as int32 with the same values."""
    n, seed, S = 5000, 21, SPEC.eet.shape[0]
    tr = scenarios.DEFAULT.sample_trace(seed, n, 3.0, SPEC.eet, device=CPU)
    drawn = np.random.default_rng(split_seed(seed, 3)[1]).integers(
        0, S, n, dtype=np.int64)
    assert tr.task_type.dtype == torch.int32
    np.testing.assert_array_equal(tr.task_type.numpy(), drawn)
    st = scenarios.DEFAULT.stack(seed, (2.0, 5.0), 3, 400, SPEC.eet,
                                 device=CPU)
    assert st.task_type.dtype == torch.int32
    for i, s in enumerate(split_seed(seed, 3)):
        want = np.random.default_rng(split_seed(s, 3)[1]).integers(
            0, S, 400, dtype=np.int64)
        np.testing.assert_array_equal(st.task_type[1, i].numpy(), want)


def test_interop_traces_carry_int32_types():
    tr = jax_trace(4, 300, 2.0)
    ours = interop.trace_from_arrays(
        np.asarray(tr.arrival), np.asarray(tr.task_type).astype(np.int64),
        np.asarray(tr.deadline), np.asarray(tr.exec_actual), device=CPU)
    assert ours.task_type.dtype == torch.int32
    np.testing.assert_array_equal(ours.task_type.numpy(),
                                  np.asarray(tr.task_type))


@pytest.mark.parametrize("system,dispatcher", [
    ("paper", None), ("paper_x2", "fair_spill"), ("tiered_x4",
                                                  "least_queued")])
def test_engine_results_do_not_depend_on_the_type_width(system, dispatcher):
    """The engine on a trace with int32 types (as the port keeps them) and
    on the same trace with int64 ones gives identical metrics, flat and
    federated, on the fused path."""
    spec = TSPEC if system == "paper" else scenarios.get_fleet(system).build()
    traces = [jax_trace(s, 80, 3.0 * (1 + (system != "paper")), spec.eet)
              for s in (0, 1)]
    narrow = stack_traces(traces)
    wide = narrow._replace(task_type=narrow.task_type.to(torch.int64))
    out = [interop.metrics_to_numpy(tengine.simulate_batch(
        tr, spec, "FELARE", dispatcher=dispatcher, use_fused_map=True,
        device=CPU)) for tr in (narrow, wide)]
    assert narrow.task_type.dtype == torch.int32
    for k in out[0]:
        np.testing.assert_array_equal(out[0][k], out[1][k], err_msg=k)
