"""The fused map-decision kernels: wrappers and their plain versions.

Counterpart of ``repro/kernels/map_fused/ops.py``, batched over B
replicates:

  * :func:`map_decide` — per event: the drop mask, and per machine the
    lowest Phase-II key among its suffered (hi) and other (lo) nominees,
    with the task holding it;
  * :func:`evict_stats` — per task: feasible now on some free machine,
    and the fastest EET (the two grid reductions FELARE's eviction
    planner needs);
  * :func:`balance_scan` — the federation dispatcher's least-loaded site
    walk (``core/dispatch/base.py::sequential_balance``).

The EET table of the first two is shared by the batch, (S, M), or given
per row, (B, S, M), as for the federation's site views. Their task types
are int32, as the reference keeps them (the engine builds that copy once
per simulation).

Each wrapper runs its plain PyTorch version when every input lies on the
CPU, and otherwise launches its CUDA kernel (``csrc/map_fused.cu``,
``csrc/balance_scan.cu``) or raises. ``LAUNCHES`` counts kernel
launches, and nothing else. Each is the roofline walker's kernel scope
(``roofline.walk.kernel``) with its cost rule (:func:`map_decide_cost`,
:func:`evict_stats_cost`, :func:`balance_scan_cost`); under the walker,
``meta`` inputs give empty ``meta`` outputs.

No padding: the kernels handle any N, M and F. A machine whose key is
BIG has no nominee, and its task is then 0, as in the TPU kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core.eet import type_rows
from repro_torch.core.equations import BIG, hash_machine
from repro_torch.kernels import build
from repro_torch.kernels.common import (
    INT,
    PTR,
    check,
    cuda_device,
    empty_meta,
    on_cpu,
    raise_on,
    rule,
    stream_ptr,
    tensor_bytes,
)
from repro_torch.roofline import hw, walk

#: Nominator / Phase-II key / drop-rule kinds the kernel implements, in
#: the order of the kernel's integer codes.
NOMINATOR_KINDS = ("min_energy_feasible", "min_completion",
                   "min_execution", "random_hash")
KEY_KINDS = ("value", "deadline", "urgency", "fcfs")
DROP_KINDS = ("stale", "stale_hopeless")

#: Kernel launches since the last reset (the CPU path never counts).
LAUNCHES = {"map_decide": 0, "evict_stats": 0, "balance_scan": 0}

_LIBS: dict = {}


def _lib(name: str):
    """The loaded library of ``csrc/<name>.cu``, its functions typed."""
    if name not in _LIBS:
        lib = build.load(name)
        if name == "map_fused":
            lib.map_decide_launch.argtypes = [PTR] * 3 + [INT] + \
                [PTR] * 2 + [INT] + [PTR] * 9 + [INT] * 6 + [PTR]
            lib.map_decide_launch.restype = INT
            lib.evict_stats_launch.argtypes = [PTR] * 3 + [INT] + \
                [PTR] * 5 + [INT] * 4 + [PTR]
            lib.evict_stats_launch.restype = INT
        else:
            lib.balance_scan_launch.argtypes = [PTR] * 5 + [INT] * 3 + [PTR]
            lib.balance_scan_launch.restype = INT
        _LIBS[name] = lib
    return _LIBS[name]


def _eet_shape(eet, B):
    """The EET shape the kernels take, and its batch stride."""
    S, M = eet.shape[-2:]
    return ((S, M), 0) if eet.dim() == 2 else ((B, S, M), S * M)


def _check_kinds(nominator, phase2_key, drop_rule):
    if nominator not in NOMINATOR_KINDS:
        raise ValueError(f"unsupported nominator kind {nominator!r}")
    if phase2_key not in KEY_KINDS:
        raise ValueError(f"unsupported phase2 key kind {phase2_key!r}")
    if drop_rule not in DROP_KINDS:
        raise ValueError(f"unsupported drop rule kind {drop_rule!r}")


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------
def map_decide_tasks(now, start, p_dyn, qfree, eet, deadline, pending,
                     task_type, *, nominator: str, phase2_key: str,
                     drop_rule: str):
    """The per-task half of ``map_decide``: each task's drop flag, Phase-II
    key, nominated machine and whether it has a nominee, all (B, N).
    Arguments as :func:`map_decide_plain`."""
    _check_kinds(nominator, phase2_key, drop_rule)
    B, N = deadline.shape
    M = eet.shape[-1]
    big = torch.full((), BIG, device=start.device)
    e = type_rows(eet, task_type)                        # (B, N, M)
    s = start[:, None, :]
    d = deadline[:, :, None]
    nowc = now[:, None]
    stale = pending & (nowc >= deadline)
    alive = pending & ~stale
    drop = stale
    if drop_rule == "stale_hopeless":
        drop = stale | (pending & (nowc + e.min(dim=2).values > deadline))

    if nominator == "random_hash":
        best = hash_machine(N, now, M)
        value = torch.arange(N, device=start.device,
                             dtype=torch.float32).expand(B, N)
        valid = alive
    else:
        free = qfree[:, None, :]
        if nominator == "min_energy_feasible":
            pd = p_dyn if p_dyn.dim() == 2 else p_dyn.expand(B, M)
            feas = (s + e <= d) & pending[:, :, None] & free
            score = torch.where(feas, pd[:, None, :] * e, big)
        elif nominator == "min_completion":
            comp = torch.where(s + e <= d, s + e,
                               torch.where(s < d, d.expand_as(e),
                                           s.expand_as(e)))
            score = torch.where(alive[:, :, None] & free, comp, big)
        else:  # min_execution
            score = torch.where(alive[:, :, None] & free, e, big)
        value, best = score.min(dim=2)
        valid = value < BIG

    if phase2_key == "value":
        key = value
    elif phase2_key == "deadline":
        scaled = 1e-6 * value
        key = deadline + scaled
    elif phase2_key == "urgency":
        slack = deadline - nowc - e.gather(2, best[:, :, None])[:, :, 0]
        key = -(1.0 / torch.where(slack.abs() < 1e-9,
                                  torch.full_like(slack, 1e-9), slack))
    else:  # fcfs
        key = torch.arange(N, device=start.device,
                           dtype=torch.float32).expand(B, N)
    return drop, key, best, valid


def argmin_by_machine(key, best, valid, suffered_task, M: int):
    """The reducing half of ``map_decide``: per machine, the lowest key
    among the valid tasks nominating it, suffered (hi) and other (lo), with
    the lowest task index on ties; ``(BIG, 0)`` where there is none.
    Returns ``(hi_key, hi_task, lo_key, lo_task)``, each (B, M)."""
    big = torch.full((), BIG, device=key.device)
    nominee = valid[:, :, None] & (
        best[:, :, None] == torch.arange(M, device=key.device))
    out = []
    for pool in (suffered_task, ~suffered_task):
        masked = torch.where(nominee & pool[:, :, None], key[:, :, None], big)
        kmin, kidx = masked.min(dim=1)                    # lowest index
        has = kmin < BIG
        out += [torch.where(has, kmin, big), torch.where(has, kidx, 0)]
    return tuple(out)


def map_decide_plain(now, start, p_dyn, qfree, eet, deadline, pending,
                     task_type, suffered_task, *, nominator: str,
                     phase2_key: str, drop_rule: str):
    """What the ``map_decide`` kernel computes, in PyTorch ops.

    now (B,) f32; start (B, M) f32; p_dyn (M,) or (B, M) f32; qfree (B, M)
    bool; eet (S, M) or (B, S, M) f32; deadline (B, N) f32; pending,
    suffered_task (B, N) bool; task_type (B, N) int32 (the plain versions
    take int64 as well). Returns ``(drop
    (B, N) bool, hi_key (B, M) f32, hi_task (B, M) int64, lo_key,
    lo_task)``.
    """
    drop, key, best, valid = map_decide_tasks(
        now, start, p_dyn, qfree, eet, deadline, pending, task_type,
        nominator=nominator, phase2_key=phase2_key, drop_rule=drop_rule)
    return (drop,) + argmin_by_machine(key, best, valid, suffered_task,
                                       eet.shape[-1])


def evict_stats_plain(start, qfree, eet, deadline, pending, task_type):
    """What the ``evict_stats`` kernel computes, in PyTorch ops.

    Returns ``(task_feas_now (B, N) bool, min_exec (B, N) f32)``.
    """
    e = type_rows(eet, task_type)
    feas = ((start[:, None, :] + e <= deadline[:, :, None])
            & pending[:, :, None] & qfree[:, None, :])
    return feas.any(dim=2), e.min(dim=2).values


def balance_scan_plain(load0, unassigned, target, home, *, max_new=None):
    """What the ``balance_scan`` kernel computes, in PyTorch ops.

    load0 (B, F) int64; unassigned, target (B, N) bool; home (B, N)
    int64. Returns the (B, N) int64 site of every task: task k, with c_k
    new (unassigned) tasks before it, sees the loads L_{c_k} after their
    increments and takes ``argmin(L_{c_k})`` (lowest site on ties) if
    ``target[k]``, else ``home[k]``. So the walk goes over the ranks of
    the new tasks, not over all tasks: rank j's span, the tasks with
    c_k = j, shares one argmin, and its new task adds one to its site.
    ``max_new`` bounds the count of new tasks in any row; ``None`` reads
    it from ``unassigned``, one host read.
    """
    F = load0.shape[1]
    if max_new is None:
        max_new = int(unassigned.sum(1).max())
    new = unassigned.to(torch.int64)
    before = new.cumsum(1) - new                          # c_k
    load, sites = load0, home
    for j in range(max_new + 1):
        span = before == j
        best = load.argmin(1, keepdim=True)               # lowest site
        sites = torch.where(span & target, best, sites)
        if j == max_new:
            break
        pick = span & unassigned                          # rank j's task
        s = torch.where(pick, sites, 0).sum(1, keepdim=True)
        inc = pick.any(1, keepdim=True) & (s >= 0) & (s < F)
        load = load.scatter_add(1, s.clamp(0, F - 1), inc.to(load.dtype))
    return sites


# --------------------------------------------------------------------------
# Cost rules: the work each function defines (float32 CUDA cores)
# --------------------------------------------------------------------------
def map_decide_cost(now, start, p_dyn, qfree, eet, deadline, pending,
                    task_type, suffered_task, **_kinds) -> dict:
    """Every input read once, the five outputs written once; per task and
    machine four operations (the EET gather, Eq. 1's sum, Eq. 2's
    product, the feasibility test) and per task two (the drop rule and
    the Phase-II key)."""
    B, N = deadline.shape
    M = eet.shape[-1]
    outs = B * N + 2 * B * M * (4 + 8)          # drop; (key f32, task i64)
    return rule(B * N * (4 * M + 2),
                tensor_bytes(now, start, p_dyn, qfree, eet, deadline,
                             pending, task_type, suffered_task) + outs,
                hw.PEAK_FLOPS_F32)


def evict_stats_cost(start, qfree, eet, deadline, pending,
                     task_type) -> dict:
    """Every input read once, ``task_feas_now`` (bool) and ``min_exec``
    (float32) written once; per type and machine a sum and two minima,
    per task three comparisons."""
    B, N = deadline.shape
    S, M = eet.shape[-2:]
    return rule(B * (3 * S * M + 3 * N),
                tensor_bytes(start, qfree, eet, deadline, pending,
                             task_type) + B * N * (1 + 4),
                hw.PEAK_FLOPS_F32)


def balance_scan_cost(load0, unassigned, target, home) -> dict:
    """Every input read once, the int64 sites written once; one select
    per task and one argmin over the F sites per new task. The new tasks
    are the data's count (one host read) where the data can be read, and
    every task on ``meta`` inputs (the walk's longest case)."""
    B, F = load0.shape
    N = unassigned.shape[1]
    new = B * N if walk.is_meta(unassigned) else int(unassigned.sum())
    return rule(B * N + new * F,
                tensor_bytes(load0, unassigned, target, home) + B * N * 8,
                hw.PEAK_FLOPS_F32)


def _map_decide_meta(now, start, p_dyn, qfree, eet, deadline, *_a, **_k):
    B, N = deadline.shape
    M = eet.shape[-1]
    key, task = ((B, M), torch.float32), ((B, M), torch.int64)
    return tuple(empty_meta(*spec) for spec in (
        ((B, N), torch.bool), key, task, key, task))


def _evict_stats_meta(start, qfree, eet, deadline, *_a):
    B, N = deadline.shape
    return empty_meta((B, N), torch.bool), empty_meta((B, N), torch.float32)


def _balance_scan_meta(load0, unassigned, *_a):
    return empty_meta(unassigned.shape, torch.int64)


# --------------------------------------------------------------------------
# Wrappers
# --------------------------------------------------------------------------
@walk.kernel("map_decide", map_decide_cost, _map_decide_meta)
def map_decide(now, start, p_dyn, qfree, eet, deadline, pending, task_type,
               suffered_task, *, nominator: str, phase2_key: str,
               drop_rule: str):
    """One fused pass: drop mask + per-machine Phase-II argmins.

    Arguments and results as :func:`map_decide_plain`. ``task_type``
    entries must lie in ``[0, S)``; the kernel does not check them.
    """
    _check_kinds(nominator, phase2_key, drop_rule)
    args = (now, start, p_dyn, qfree, eet, deadline, pending, task_type,
            suffered_task)
    if on_cpu(*args):
        return map_decide_plain(*args, nominator=nominator,
                                phase2_key=phase2_key, drop_rule=drop_rule)
    dev = cuda_device(start)
    B, N = deadline.shape
    M = eet.shape[-1]
    eet_shape, eet_bstride = _eet_shape(eet, B)
    f32, b8, i32, i64 = torch.float32, torch.bool, torch.int32, torch.int64
    pdyn_shape = (M,) if p_dyn.dim() == 1 else (B, M)
    ptrs = [
        check(now, "now", f32, (B,), dev),
        check(start, "start", f32, (B, M), dev),
        check(p_dyn, "p_dyn", f32, pdyn_shape, dev),
        check(qfree, "qfree", b8, (B, M), dev),
        check(eet, "eet", f32, eet_shape, dev),
        check(deadline, "deadline", f32, (B, N), dev),
        check(pending, "pending", b8, (B, N), dev),
        check(task_type, "task_type", i32, (B, N), dev),
        check(suffered_task, "suffered_task", b8, (B, N), dev),
    ]
    drop = torch.empty((B, N), dtype=b8, device=dev)
    hi_key = torch.empty((B, M), dtype=f32, device=dev)
    hi_task = torch.empty((B, M), dtype=i64, device=dev)
    lo_key = torch.empty((B, M), dtype=f32, device=dev)
    lo_task = torch.empty((B, M), dtype=i64, device=dev)
    outs = (drop, hi_key, hi_task, lo_key, lo_task)
    rc = _lib("map_fused").map_decide_launch(
        *ptrs[:3], 0 if p_dyn.dim() == 1 else M, *ptrs[3:5], eet_bstride,
        *ptrs[5:],
        *(o.data_ptr() for o in outs), B, N, M,
        NOMINATOR_KINDS.index(nominator), KEY_KINDS.index(phase2_key),
        DROP_KINDS.index(drop_rule), stream_ptr(dev))
    raise_on(rc, "map_decide")
    LAUNCHES["map_decide"] += 1
    return outs


@walk.kernel("evict_stats", evict_stats_cost, _evict_stats_meta)
def evict_stats(start, qfree, eet, deadline, pending, task_type):
    """Per-task eviction-planner stats over the pre-eviction grid.

    Arguments and results as :func:`evict_stats_plain`; on the card
    ``task_type`` is int32 with entries in ``[0, S)`` (not checked).
    """
    args = (start, qfree, eet, deadline, pending, task_type)
    if on_cpu(*args):
        return evict_stats_plain(*args)
    dev = cuda_device(start)
    B, N = deadline.shape
    S, M = eet.shape[-2:]
    eet_shape, eet_bstride = _eet_shape(eet, B)
    ptrs = [
        check(start, "start", torch.float32, (B, M), dev),
        check(qfree, "qfree", torch.bool, (B, M), dev),
        check(eet, "eet", torch.float32, eet_shape, dev),
        check(deadline, "deadline", torch.float32, (B, N), dev),
        check(pending, "pending", torch.bool, (B, N), dev),
        check(task_type, "task_type", torch.int32, (B, N), dev),
    ]
    feas = torch.empty((B, N), dtype=torch.bool, device=dev)
    min_exec = torch.empty((B, N), dtype=torch.float32, device=dev)
    rc = _lib("map_fused").evict_stats_launch(
        *ptrs[:3], eet_bstride, *ptrs[3:], feas.data_ptr(),
        min_exec.data_ptr(), B, N, M, S, stream_ptr(dev))
    raise_on(rc, "evict_stats")
    LAUNCHES["evict_stats"] += 1
    return feas, min_exec


@walk.kernel("balance_scan", balance_scan_cost, _balance_scan_meta)
def balance_scan(load0, unassigned, target, home):
    """The dispatcher's least-loaded walk as one kernel call.

    Arguments and result as :func:`balance_scan_plain` (F at most 1024 on
    the card); the contract of ``sequential_balance``'s ``impl`` hook.
    """
    args = (load0, unassigned, target, home)
    if on_cpu(*args):
        return balance_scan_plain(*args)
    dev = cuda_device(load0)
    B, F = load0.shape
    N = unassigned.shape[1]
    i64, b8 = torch.int64, torch.bool
    ptrs = [
        check(load0, "load0", i64, (B, F), dev),
        check(unassigned, "unassigned", b8, (B, N), dev),
        check(target, "target", b8, (B, N), dev),
        check(home, "home", i64, (B, N), dev),
    ]
    sites = torch.empty((B, N), dtype=i64, device=dev)
    rc = _lib("balance_scan").balance_scan_launch(
        *ptrs, sites.data_ptr(), B, N, F, stream_ptr(dev))
    raise_on(rc, "balance_scan")
    LAUNCHES["balance_scan"] += 1
    return sites
