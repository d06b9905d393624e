"""Discrete-event simulation engine for the HEC system, batched, in PyTorch.

Counterpart of ``repro/core/engine.py`` for the flat system and the
multi-site federation, with engine observers, the energy-budget gate,
machine faults and the edge-cloud network. Semantics follow Sec. III of
the paper and the reference op for op:

  * mapping events fire on task arrival and task completion, plus a
    progress event at the earliest pending deadline;
  * machines serve their bounded local queues FCFS;
  * a running task that passes its deadline is killed at the deadline;
  * a queued task whose deadline passed before it starts is dropped with
    zero energy.

The reference runs one ``lax.while_loop`` per trace and ``vmap``s it; the
port runs one Python loop over a batch of B traces. Each iteration runs
the stages finalize -> admit -> [faults ->] dispatch -> map -> start on
every replicate, then keeps the new state only where the replicate is still
active (its next event time is finite and it has taken fewer than
``8 N + 64`` steps):
``where(active, new, old)`` on every field, ``steps`` included, so a
finished replicate stays frozen as under ``vmap``. The host reads
``active.any()`` once every :data:`CHECK_EVERY` iterations; the extra
iterations are harmless because inactive replicates are frozen.

Task types come in as the trace keeps them (int32, as in the reference).
Each simulation makes one int64 copy, which every gather, scatter and
index of the loop takes, and keeps the int32 one for the kernels, so no
iteration casts.

Observers (:mod:`repro_torch.core.observe`) are notified after every
stage, in :data:`STAGES` order, and their aux is frozen with the state.
A dynamic observer (a finite ``energy_budget``) gates the loop: where it
reports ``halted``, arrivals stop driving events, nothing is admitted and
the admit stage cancels pending tasks and flushes the local queues. With
no observers the loop issues no op for them, and with no dynamic
observer none for the gate.

A federation partitions the M machines into F sites. The dispatch stage
gives each newly-admitted task a site, once; the map stage then runs the
policy once per iteration over B * F rows, row ``b * F + f`` being site
``f`` of replicate ``b`` (the counterpart of the reference's ``vmap``
over sites), so the launches per iteration do not grow with F. Sites
that are equal contiguous blocks of m machines fold by reshaping the
(B, M) state to (B * F, m); any other partition folds into (B * F, M)
views that mask the other sites' machines out. With one site both stages
are the flat path's.

A machine dynamics (:mod:`repro_torch.core.faults`) adds the ``faults``
stage: it evolves each replicate's per-machine health, flushes the
queues of machines that died and kills their running tasks (whose
partial energy is spent and wasted); those orphans re-enter dispatch in
the same event, or are cancelled past ``max_retries``, and under a
``with_backup`` policy a killed task fails over to its first healthy,
non-full backup. Downstream, dead machines read avail=BIG, EET=BIG,
empty and full queues at the dispatch and map stages, like out-of-site
machines, stragglers' EET columns and runtimes are slowdown-scaled, and
dead machines never start a task. The health-masked EET is one table
per replicate, (B, S, M), so the site views' tables are folded from it
every event. Scheduled dynamics (outage windows) add their window edges
to the next-event times. With ``dynamics=None`` or ``"none"`` none of
this runs: the state carries no health fields and the loop issues not
one op more.

A network model (:mod:`repro_torch.core.network`) makes the dispatch
stage pay each fresh dispatch's link from the task's origin site: the
task's ready time becomes ``now + lat`` (the map stage hides it until it
lands, and its landing drives an event of its own), the link energy is
charged to the dynamic account and tallied per destination tier, and
in-transit tasks whose deadline passed are cancelled. The per-task link
costs are gathered once per simulation, (B, N, F). An orphan whose site
the faults stage cleared pays its link again; a failover to a backup
keeps its ready time. With ``network=None`` or ``"none"`` the state
carries no transfer fields and the loop issues not one op more.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import dispatch, fairness, faults, observe, spans
from repro_torch.core import network as net_mod
from repro_torch.core.device import resolve_device
from repro_torch.core.dispatch.base import site_minima
from repro_torch.core.eet import type_rows
from repro_torch.core.equations import BIG, seq_dot, seq_sum
from repro_torch.core.policy import MachineView
from repro_torch.core.policy.base import set_masked
from repro_torch.core.types import (
    CANCELLED,
    COMPLETED,
    MISSED,
    PENDING,
    QUEUED,
    RUNNING,
    UNARRIVED,
    MapAction,
    Metrics,
    SimState,
    SystemArrays,
    Trace,
    site_membership,
)

INF = float("inf")

#: The event stages, in the order the loop runs them and notifies the
#: observers (the flat system has no dispatch stage of its own, but its
#: observers are notified there all the same; ``faults`` runs, and is
#: notified, only when a machine dynamics is attached).
STAGES = ("finalize", "admit", "faults", "dispatch", "map", "start")

#: Iterations between two host reads of "is any replicate still active".
CHECK_EVERY = 32

#: The most machines whose sums the faults stage takes left to right, as
#: the reference's compiled code does (:func:`_killed_energy`).
SEQ_SUM_MAX = 8

#: Always-on counters since the last reset. ``loop_iterations``: batched
#: loop iterations run (each calls the map stage's policy once for the
#: whole batch). ``checks``: periodic checks run; ``check_wait_ns``: the
#: host's ns blocked in them. ``issue_ns``: the host's ns from the end of
#: a check to the end of its iteration, over ``issue_iters`` such check
#: iterations; the check has just emptied the launch queue, so this is
#: the host's own time to issue an iteration. A loop's first iteration
#: is left out of these two: in a fresh process it also loads each
#: kernel it launches first, hundreds of ms on the card. The loop looks
#: the dict up at each update, so a caller may swap it.
COUNTS = {"loop_iterations": 0, "checks": 0, "check_wait_ns": 0,
          "issue_ns": 0, "issue_iters": 0}


def _count_by_type(counts, task_type, mask):
    """``counts[b, task_type[b, k]] += mask[b, k]`` (the reference's
    ``segment_sum`` over types), as a new tensor. Any valid index tensor
    serves for ``task_type``: an entry whose mask is off adds 0."""
    return counts.scatter_add(1, task_type, mask.to(counts.dtype))


def _init_state(trace: Trace, n_machines: int, queue_size: int,
                n_types: int, n_sites: int = 1, health: bool = False,
                backup_k: int = 0, n_tiers: int = 0) -> SimState:
    """The state before the first event. With one site and no network
    every task's site is 0 from the start (the reference gives it 0 at
    admission); otherwise it is -1 until the task is dispatched.
    ``health`` adds the fault fields (every machine alive at nominal
    speed, no retries), ``backup_k`` the backup table, and ``n_tiers``
    > 0 (a network) the ready times (the arrivals) and the per-tier
    transfer energy (0)."""
    B, n = trace.arrival.shape
    M, Q, S = n_machines, queue_size, n_types
    dev = trace.arrival.device
    f32, i64 = torch.float32, torch.int64

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return SimState(
        now=full((B,), 0.0, f32),
        status=full((B, n), UNARRIVED, i64),
        site=full((B, n), 0 if n_sites == 1 and not n_tiers else -1, i64),
        run_task=full((B, M), -1, i64),
        run_start=full((B, M), 0.0, f32),
        run_end_act=full((B, M), INF, f32),
        run_end_exp=full((B, M), 0.0, f32),
        run_success=full((B, M), False, torch.bool),
        queue=full((B, M, Q), -1, i64),
        qlen=full((B, M), 0, i64),
        busy_time=full((B, M), 0.0, f32),
        e_dyn=full((B,), 0.0, f32),
        e_wasted=full((B,), 0.0, f32),
        completed=full((B, S), 0, i64),
        missed=full((B, S), 0, i64),
        cancelled=full((B, S), 0, i64),
        arrived=full((B, S), 0, i64),
        steps=full((B,), 0, i64),
        alive=full((B, M), True, torch.bool) if health else None,
        slowdown=full((B, M), 1.0, f32) if health else None,
        retries=full((B, n), 0, i64) if health else None,
        backup=full((B, n, backup_k), -1, i64) if backup_k else None,
        ready=trace.arrival.clone() if n_tiers else None,
        e_xfer=full((B, n_tiers), 0.0, f32) if n_tiers else None,
    )


def _next_event_time(st: SimState, trace: Trace,
                     halted: Optional[torch.Tensor] = None,
                     wake_ts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B,) earliest of: next arrival, next completion, earliest pending
    deadline (the progress guard), and with a network the next landing of
    an in-transit task. ``inf`` when nothing is left. Where ``halted``
    (B,) is set, arrivals no longer drive events. ``wake_ts`` (B, W) are
    a scheduled dynamics' window edges: each fires once, as only strictly
    future ones count."""
    inf = torch.full((), INF, device=st.now.device)
    t_arr = torch.where(st.status == UNARRIVED, trace.arrival, inf).amin(1)
    if halted is not None:
        t_arr = torch.where(halted, INF, t_arr)
    t_comp = st.run_end_act.amin(1)
    pending = st.status == PENDING
    t_dead = torch.where(pending, trace.deadline, inf).amin(1)
    t = torch.minimum(torch.minimum(t_arr, t_comp), t_dead)
    if st.ready is not None:
        landing = pending & (st.ready > st.now[:, None])
        t = torch.minimum(t, torch.where(landing, st.ready, inf).amin(1))
    if wake_ts is None:
        return t
    t_wake = torch.where(wake_ts > st.now[:, None], wake_ts, inf).amin(1)
    return torch.minimum(t, t_wake)


# ---------------------------------------------------------------------------
# Event stages. Each is a pure SimState -> SimState map over the batch.
# ---------------------------------------------------------------------------
def _stage_finalize(st: SimState, trace: Trace, sysarr: SystemArrays):
    """Close out machines whose running task's actual end <= now."""
    now = st.now[:, None]
    done = (st.run_task >= 0) & (st.run_end_act <= now)
    idx = torch.where(done, st.run_task, 0)
    ttype = trace.task_type.gather(1, idx)
    dur = torch.where(done, st.run_end_act - st.run_start, 0.0)
    energy = sysarr.p_dyn * dur
    ok = done & st.run_success
    ko = done & ~st.run_success
    status = set_masked(st.status, idx, done,
                        torch.where(ok, COMPLETED, MISSED))
    return st._replace(
        status=status,
        run_task=torch.where(done, -1, st.run_task),
        run_end_act=torch.where(done, INF, st.run_end_act),
        run_end_exp=torch.where(done, now, st.run_end_exp),
        run_success=st.run_success & ~done,
        completed=_count_by_type(st.completed, ttype, ok),
        missed=_count_by_type(st.missed, ttype, ko),
        e_dyn=st.e_dyn + energy.sum(1),
        e_wasted=st.e_wasted + torch.where(ko, energy, 0.0).sum(1),
        busy_time=st.busy_time + dur,
    )


def _stage_admit(st: SimState, trace: Trace,
                 halted: Optional[torch.Tensor] = None):
    """Admit newly-arrived tasks to the arriving queue.

    Where a dynamic observer reports ``halted`` (B,), the replicate stops
    taking work: nothing is admitted, every pending task is cancelled and
    the local queues are flushed (:func:`_halt_shutdown`). Tasks already
    running finish normally.
    """
    newly = (st.status == UNARRIVED) & (trace.arrival <= st.now[:, None])
    if halted is not None:
        newly = newly & ~halted[:, None]
    st = st._replace(
        status=torch.where(newly, PENDING, st.status),
        arrived=_count_by_type(st.arrived, trace.task_type, newly),
    )
    if halted is None:
        return st
    return _halt_shutdown(st, trace, halted)


def _halt_shutdown(st: SimState, trace: Trace, halted: torch.Tensor):
    """Cancel pending tasks and flush local queues where ``halted``."""
    B, M, Q = st.queue.shape
    n = st.status.shape[1]
    drop = halted[:, None] & (st.status == PENDING)
    status = torch.where(drop, CANCELLED, st.status)
    cancelled = _count_by_type(st.cancelled, trace.task_type, drop)
    victim = halted[:, None, None] & (st.queue >= 0)
    vflat = victim.reshape(B, M * Q)
    qflat = st.queue.reshape(B, M * Q)
    status = set_masked(status, qflat, vflat, CANCELLED)
    cancelled = _count_by_type(
        cancelled, trace.task_type.gather(1, qflat.clamp(0, n - 1)), vflat)
    return st._replace(
        status=status, cancelled=cancelled,
        queue=torch.where(victim, -1, st.queue),
        qlen=torch.where(halted[:, None], 0, st.qlen))


class _Health(NamedTuple):
    """A machine dynamics and what the faults stage needs with it, static
    per simulation."""

    dynamics: object
    max_retries: int
    backup_k: int
    sites: tuple                # (M,) static partition
    n_sites: int
    site_ids: torch.Tensor      # (M,) int64 the partition on the device
    horizon: torch.Tensor       # (B,) f32 each trace's max deadline
    wake_ts: Optional[torch.Tensor]  # (B, W) f32 window edges, or None
    earlier: torch.Tensor       # (M, M) bool, [m, j] = j < m


def _make_health(dynamics, select_fn, sites: tuple, trace: Trace
                 ) -> Optional[_Health]:
    """The :class:`_Health` of a simulation, ``None`` without dynamics."""
    if dynamics is None:
        return None
    dev = trace.arrival.device
    M = len(sites)
    horizon = trace.deadline.amax(1)
    wake = tuple(float(w) for w in dynamics.wake_fracs())
    wake_ts = None
    if wake:
        wake_ts = torch.tensor(wake, dtype=torch.float32,
                               device=dev)[None, :] * horizon[:, None]
    m = torch.arange(M, device=dev)
    return _Health(dynamics, int(getattr(dynamics, "max_retries", 3)),
                   int(getattr(select_fn, "backup_k", 0)), sites,
                   max(sites) + 1,
                   torch.as_tensor(sites, dtype=torch.int64, device=dev),
                   horizon, wake_ts, m[None, :] < m[:, None])


def _stage_faults(st: SimState, trace: Trace, sysarr: SystemArrays,
                  h: _Health) -> SimState:
    """Evolve machine health and orphan the casualties (the reference's
    ``_stage_faults``, in its order):

      1. ``dynamics.step`` proposes the next ``(alive, slowdown)``.
      2. Newly-dead machines flush their local queues: each queued task
         is orphaned, its retry count incremented; it re-enters dispatch
         (PENDING, site cleared) unless the count exceeds
         ``max_retries``, when it is CANCELLED and keeps its site.
      3. Newly-dead machines kill their running task: the partial run's
         dynamic energy is spent and wasted, and the task is orphaned
         the same way, except that under ``with_backup`` an orphan with
         a healthy, non-full backup is enqueued there directly (QUEUED
         on the backup's site). Queue victims never fail over.

    Every scatter sends masked-out entries to an extra column, or adds 0;
    nothing reads back to the host.
    """
    B, M, Q = st.queue.shape
    n = st.status.shape[1]
    alive, slowdown = h.dynamics.step(faults.FaultContext(
        now=st.now, steps=st.steps, horizon=h.horizon, alive=st.alive,
        slowdown=st.slowdown, site_of_machine=h.sites, n_sites=h.n_sites))
    alive = alive.to(torch.bool)
    slowdown = slowdown.to(torch.float32)
    died = st.alive & ~alive

    # -- 2. flush dead machines' local queues ---------------------------------
    qflat = st.queue.reshape(B, M * Q)
    qvict = (died[:, :, None] & (st.queue >= 0)).reshape(B, M * Q)
    qsafe = qflat.clamp(0, n - 1)
    retries = _count_by_type(st.retries, qsafe, qvict)
    q_exh = qvict & (retries.gather(1, qsafe) > h.max_retries)
    status = set_masked(st.status, qflat, qvict,
                        torch.where(q_exh, CANCELLED, PENDING))
    cancelled = _count_by_type(st.cancelled, trace.task_type.gather(1, qsafe),
                               q_exh)
    site = set_masked(st.site, qflat, qvict & ~q_exh, -1)
    queue = torch.where(died[:, :, None], -1, st.queue)
    qlen = torch.where(died, 0, st.qlen)

    # -- 3. kill running tasks on newly-dead machines ------------------------
    kill = died & (st.run_task >= 0)
    vict = torch.where(kill, st.run_task, 0)
    dur = torch.where(kill, st.now[:, None] - st.run_start, 0.0)
    spent, wasted = _killed_energy(sysarr.p_dyn, dur)
    retries = _count_by_type(retries, vict, kill)
    r_exh = kill & (retries.gather(1, vict) > h.max_retries)
    cancelled = _count_by_type(cancelled, trace.task_type.gather(1, vict),
                               r_exh)
    orphan = kill & ~r_exh
    new_site = -1
    if h.backup_k:
        target, slot = _failover(st.backup, vict, orphan, alive, qlen, Q, h)
        moved = target >= 0
        queue = _enqueue(queue, target, slot, vict, moved)
        qlen = _count_by_type(qlen, target.clamp(min=0), moved)
        new_status = torch.where(moved, QUEUED, PENDING)
        new_site = torch.where(moved, h.site_ids[target.clamp(min=0)], -1)
    else:
        new_status = PENDING
    status = set_masked(status, vict, kill,
                        torch.where(r_exh, CANCELLED, new_status))
    site = set_masked(site, vict, orphan, new_site)
    now = st.now[:, None]
    return st._replace(
        alive=alive, slowdown=slowdown, status=status, site=site,
        queue=queue, qlen=qlen, retries=retries, cancelled=cancelled,
        run_task=torch.where(kill, -1, st.run_task),
        run_end_act=torch.where(kill, INF, st.run_end_act),
        run_end_exp=torch.where(kill, now, st.run_end_exp),
        run_success=st.run_success & ~kill,
        e_dyn=st.e_dyn + spent, e_wasted=st.e_wasted + wasted,
        busy_time=st.busy_time + dur)


def _killed_energy(p_dyn, dur):
    """(B,) dynamic energy spent, and wasted, by the killed runs.

    Up to :data:`SEQ_SUM_MAX` machines this is the reference's compiled
    sums: the spent energy left to right with an FMA per machine, the
    wasted one (a select of the products) on the rounded products. Past
    it XLA vectorizes both, which the port does not mimic: one reduction
    serves both there (ROADMAP C)."""
    if dur.shape[1] <= SEQ_SUM_MAX:
        return seq_dot(p_dyn, dur), seq_sum(p_dyn * dur)
    spent = (p_dyn * dur).sum(1)
    return spent, spent


def _failover(backup, vict, orphan, alive, qlen, Q: int, h: _Health):
    """(B, M) the backup machine each killed task fails over to (-1 =
    none), and its queue slot there.

    The reference scans the dead machines in index order, so that two
    orphans favouring one backup cannot both take its last slot; an
    orphan takes its first backup that is alive and has room at its turn.
    With one backup that is a ranking: the orphan of rank r among those
    naming backup b fails over iff ``qlen[b] + r < Q``. With more, a
    fall-through can take a slot a later orphan wanted first, so the
    scan runs over the machines.
    """
    B, M = vict.shape
    k = h.backup_k
    bks = backup.gather(1, vict[:, :, None].expand(B, M, k))      # (B, M, k)
    bsafe = bks.clamp(min=0)
    ok = ((bks >= 0) & orphan[:, :, None]
          & alive.gather(1, bsafe.reshape(B, M * k)).reshape(B, M, k))
    if k == 1:
        b, ok = bks[:, :, 0], ok[:, :, 0]
        rank = (ok[:, None, :] & (b[:, None, :] == b[:, :, None])
                & h.earlier).sum(2)
        slot = qlen.gather(1, bsafe[:, :, 0]) + rank
        return torch.where(ok & (slot < Q), b, -1), slot
    target = torch.full_like(vict, -1)
    slot = torch.zeros_like(vict)
    for m in range(M):
        q = qlen.gather(1, bsafe[:, m])                           # (B, k)
        room = ok[:, m] & (q < Q)
        first = room.to(torch.int32).argmax(1, keepdim=True)      # lowest
        moved = room.any(1)
        t = torch.where(moved, bks[:, m].gather(1, first)[:, 0], -1)
        target[:, m] = t
        slot[:, m] = q.gather(1, first)[:, 0]
        qlen = _count_by_type(qlen, t.clamp(min=0)[:, None],
                              moved[:, None])
    return target, slot


def _enqueue(queue, target, slot, task, mask):
    """``queue[b, target[b, j], slot[b, j]] = task[b, j]`` where
    ``mask[b, j]``; the rest go to an extra column that is cut off."""
    B, M, Q = queue.shape
    flat = torch.cat([queue.reshape(B, M * Q),
                      queue.new_full((B, 1), -1)], dim=1)
    idx = torch.where(mask, target.clamp(min=0) * Q + slot, M * Q)
    return flat.scatter(1, idx, task)[:, :M * Q].reshape(B, M, Q)


def _health_eet(sysarr: SystemArrays, st: SimState) -> torch.Tensor:
    """(B, S, M) EET as the dispatch and map stages see it under faults:
    dead machines' columns BIG, stragglers' scaled by their slowdown."""
    return torch.where(st.alive[:, None, :],
                       sysarr.eet * st.slowdown[:, None, :], BIG)


class _Fold(NamedTuple):
    """How a federation's F site views of each replicate fold into the
    batch (rows ``b * F + f``). Static per simulator."""

    n_sites: int
    block: bool                # equal contiguous machine blocks
    owner: torch.Tensor        # (M,) int64 site of each machine
    members: torch.Tensor      # (F, M) bool
    site_range: torch.Tensor   # (F, 1) int64 site ids
    sysarr: SystemArrays       # per-site tables, (F, S, w) and (F, w)
    eet_min_site: torch.Tensor  # (S, F) each type's fastest EET per site


class _SiteRows(NamedTuple):
    """The folded arrays that do not change during a simulation."""

    task_type: torch.Tensor    # (B * F, N) int64
    task_type32: torch.Tensor  # (B * F, N) int32, for the kernels
    deadline: torch.Tensor     # (B * F, N)
    sysarr: SystemArrays       # eet (B * F, S, w), p_dyn (B * F, w) or (M,)


def _make_fold(sysarr: SystemArrays, sites: tuple) -> _Fold:
    """The fold of a partition: the block fold when every site is an
    equal contiguous block of machines (the reference's test,
    ``repro/core/engine.py:614-618``), else the masked fold. The choice
    matters beyond speed: the random nominator hashes into the view's
    width."""
    S, M = sysarr.eet.shape
    F = max(sites) + 1
    dev = sysarr.eet.device
    owner = torch.as_tensor(sites, dtype=torch.int64, device=dev)
    members = torch.as_tensor(site_membership(sites), device=dev)
    m = M // F
    block = M % F == 0 and bool(
        (np.asarray(sites) == np.repeat(np.arange(F), m)).all())
    if block:
        tables = SystemArrays(
            eet=sysarr.eet.reshape(S, F, m).transpose(0, 1).contiguous(),
            p_dyn=sysarr.p_dyn.reshape(F, m),
            p_idle=sysarr.p_idle.reshape(F, m))
    else:
        tables = sysarr._replace(
            eet=torch.where(members[:, None, :], sysarr.eet[None], BIG))
    return _Fold(F, block, owner, members,
                 torch.arange(F, device=dev)[:, None], tables,
                 site_minima(sysarr.eet, members))


def _site_rows(fold: _Fold, trace: Trace, types32: torch.Tensor
               ) -> _SiteRows:
    """Build the folded task arrays and tables once per simulation
    (``trace`` with int64 types, ``types32`` the int32 ones)."""
    B = trace.arrival.shape[0]
    F = fold.n_sites
    tables = fold.sysarr
    eet = tables.eet.repeat(B, 1, 1)
    if fold.block:
        tables = SystemArrays(eet, tables.p_dyn.repeat(B, 1),
                              tables.p_idle.repeat(B, 1))
    else:
        tables = tables._replace(eet=eet)
    return _SiteRows(trace.task_type.repeat_interleave(F, dim=0),
                     types32.repeat_interleave(F, dim=0),
                     trace.deadline.repeat_interleave(F, dim=0), tables)


def _site_eet(fold: _Fold, eet: torch.Tensor) -> torch.Tensor:
    """The site views' (B * F, S, w) EET tables folded from per-replicate
    (B, S, M) ones, as :func:`_make_fold` folds the shared table;
    contiguous, as the kernels take them (at B = 1 the fold is a view)."""
    B, S, M = eet.shape
    F = fold.n_sites
    if fold.block:
        return eet.reshape(B, S, F, M // F).transpose(1, 2).reshape(
            B * F, S, M // F).contiguous()
    return torch.where(fold.members[:, None, :], eet[:, None],
                       BIG).reshape(B * F, S, M)


def _max_admissions(arrival: torch.Tensor) -> int:
    """The most tasks one event can admit, read once per simulation.

    An event never passes the earliest arrival still to come, so the
    tasks one event admits share one arrival time: the largest count of
    equal arrival times in a replicate bounds them, and with them the
    tasks the dispatch stage finds new. (Under faults the orphans of the
    machines that died at the event come on top; the engine adds them.)
    """
    a = arrival.sort(dim=1).values
    B, n = a.shape
    first = torch.ones_like(a, dtype=torch.bool)
    first[:, 1:] = a[:, 1:] != a[:, :-1]
    group = first.cumsum(1) - 1 + n * torch.arange(
        B, device=a.device)[:, None]
    # repro: allow-sync[once per simulation, in the set-up]
    return int(torch.bincount(group.flatten(), minlength=B * n).max())


class _Net(NamedTuple):
    """A network's link costs and tiers, static per simulation."""

    lat: torch.Tensor         # (B, N, F) f32 latency of each task's links
    en: torch.Tensor          # (B, N, F) f32 energy of each task's links
    site_tier: torch.Tensor   # (F,) int64 tier of each site
    tier_range: torch.Tensor  # (T,) int64 tier ids


def _make_net(network, tiers: tuple, n_types: int, trace: Trace
              ) -> Optional[_Net]:
    """The :class:`_Net` of a simulation, ``None`` without a network.

    Row ``k`` of the link tables prices task ``k``'s origin (a salted
    counter hash over the device-tier sites) against every site:
    ``lat[b, k, s] = cost_lat[type[b, k], origin[k], s]``, gathered once.
    """
    if network is None:
        return None
    dev = trace.arrival.device
    n = trace.arrival.shape[1]
    lat, en = network.cost_tables(tiers, n_types)
    origin = net_mod.hash_origins(n, net_mod.origin_sites(tiers),
                                  int(getattr(network, "salt", 0)), dev)
    types = trace.task_type
    return _Net(torch.as_tensor(lat, device=dev)[types, origin],
                torch.as_tensor(en, device=dev)[types, origin],
                torch.as_tensor(tiers, dtype=torch.int64, device=dev),
                torch.arange(max(tiers) + 1, device=dev))


def _stage_dispatch(st: SimState, trace: Trace, sysarr: SystemArrays,
                    dispatcher, fold: Optional[_Fold], fairness_factor: float,
                    max_new: int, eet_h: Optional[torch.Tensor] = None,
                    net: Optional[_Net] = None):
    """Give newly-admitted tasks their site (dispatch-once).

    A task is dispatched at the first event where it is PENDING and still
    siteless; its site never changes afterwards, unless its machine dies
    and the faults stage clears it. The context reads the post-admit
    queue lengths and running machines: tasks dispatched but still
    pending do not count toward a site's load. Under faults it reads the
    health-masked (B, S, M) table ``eet_h`` and the machines' health.
    With one site (``fold`` is ``None``, which the loop passes here only
    with a network) every task goes to site 0. With a network ``net``
    each fresh dispatch then pays its link (:func:`_pay_links`).
    """
    new = (st.status == PENDING) & (st.site < 0)
    if fold is None:
        sites = torch.zeros_like(st.site)
    else:
        health = eet_h is not None
        ctx = dispatch.DispatchContext(
            now=st.now, unassigned=new, task_type=trace.task_type,
            deadline=trace.deadline, qlen=st.qlen, running=st.run_task >= 0,
            completed=st.completed, arrived=st.arrived,
            eet=eet_h if health else sysarr.eet,
            site_of_machine=fold.owner, n_sites=fold.n_sites,
            fairness_factor=fairness_factor,
            alive=st.alive if health else None,
            xfer_lat=None if net is None else net.lat,
            xfer_energy=None if net is None else net.en,
            eet_min_site=None if health else fold.eet_min_site,
            max_new=max_new)
        sites = dispatcher.dispatch(ctx).clamp(0, fold.n_sites - 1)
    st = st._replace(site=torch.where(new, sites, st.site))
    if net is None:
        return st
    return _pay_links(st, trace, new, sites, net)


def _pay_links(st: SimState, trace: Trace, new: torch.Tensor, sites,
               net: _Net) -> SimState:
    """Charge the links of this event's fresh dispatches ``new`` (B, N)
    to ``sites`` (the reference's transfer accounting, in its order):

      * the ready time at the chosen site becomes ``now + lat``;
      * the link energy is added to ``e_dyn``, and to ``e_xfer`` under
        the destination's tier: T masked sums in a fixed order, never a
        float scatter, so the card gives the same bits on every run;
      * a pending task still in transit at or past its deadline is
        CANCELLED and counted by type (the map stage cannot see it, so
        no drop rule would); its transfer energy stays spent.
    """
    s = torch.where(new, sites, 0)[..., None]     # sites are in range
    lat = net.lat.gather(2, s)[..., 0]
    en = net.en.gather(2, s)[..., 0]
    now = st.now[:, None]
    ready = torch.where(new, now + lat, st.ready)
    pay = torch.where(new, en, 0.0)
    to_tier = net.site_tier[s] == net.tier_range                # (B, N, T)
    e_xfer = st.e_xfer + torch.where(to_tier, pay[..., None], 0.0).sum(1)
    stale = ((st.status == PENDING) & (ready > now)
             & (now >= trace.deadline))
    return st._replace(
        ready=ready, e_dyn=st.e_dyn + pay.sum(1), e_xfer=e_xfer,
        status=torch.where(stale, CANCELLED, st.status),
        cancelled=_count_by_type(st.cancelled, trace.task_type, stale))


def _map_action(st: SimState, trace: Trace, sysarr: SystemArrays,
                select_fn: Callable, fairness_factor: float,
                fold: Optional[_Fold] = None,
                rows: Optional[_SiteRows] = None,
                types32: Optional[torch.Tensor] = None,
                eet_h: Optional[torch.Tensor] = None) -> MapAction:
    """The :class:`MapAction` of one batched mapping event (pre-apply).

    With a federation the policy runs once over the B * F site views and
    the per-site actions are combined: machine ``m`` takes its owner's
    ``assign``/``queue_drop`` entry, and task ``k`` its own site's
    ``drop`` entry, only once it has a site. ``suffered`` is computed
    once per replicate and shared by its F rows. ``types32`` is the
    trace's int32 copy of its types, handed to the policy for the kernels.

    Under faults (``eet_h``, the (B, S, M) health-masked table) the view
    is masked before the flat / block-fold / masked-fold split: dead
    machines read avail=BIG, an empty queue, qlen=Q and EET=BIG, as
    out-of-site machines do, and the site views' tables are folded from
    ``eet_h`` at this event. With a network, a task in transit (its ready
    time still ahead) is not pending to the policy: the kernels receive
    ``status == PENDING & ready <= now``.
    """
    suffered = fairness.suffered_types(st.completed, st.arrived,
                                       fairness_factor)
    now = st.now[:, None]
    avail_base = torch.maximum(
        torch.where(st.run_task >= 0, st.run_end_exp, now), now)
    pending = st.status == PENDING
    if st.ready is not None:
        pending = pending & (st.ready <= now)
    B, M, Q = st.queue.shape
    queue, qlen = st.queue, st.qlen
    if eet_h is not None:
        avail_base = torch.where(st.alive, avail_base, BIG)
        queue = torch.where(st.alive[:, :, None], queue, -1)
        qlen = torch.where(st.alive, qlen, Q)
        if fold is None:
            sysarr = sysarr._replace(eet=eet_h)
        else:
            rows = rows._replace(sysarr=rows.sysarr._replace(
                eet=_site_eet(fold, eet_h)))
    if fold is None:
        view = MachineView(avail_base=avail_base, queue=queue, qlen=qlen)
        return select_fn(st.now, pending, trace.task_type, trace.deadline,
                         view, sysarr, suffered, task_type32=types32)

    n = pending.shape[1]
    F = fold.n_sites
    at_site = (pending[:, None, :]
               & (st.site[:, None, :] == fold.site_range)).reshape(B * F, n)
    if fold.block:
        w = M // F
        view = MachineView(avail_base=avail_base.reshape(B * F, w),
                           queue=queue.reshape(B * F, w, Q),
                           qlen=qlen.reshape(B * F, w))
    else:
        mem = fold.members
        view = MachineView(
            avail_base=torch.where(mem, avail_base[:, None, :],
                                   BIG).reshape(B * F, M),
            queue=torch.where(mem[:, :, None], queue[:, None],
                              -1).reshape(B * F, M, Q),
            qlen=torch.where(mem, qlen[:, None, :], Q).reshape(B * F, M))
    act = select_fn(st.now.repeat_interleave(F), at_site, rows.task_type,
                    rows.deadline, view, rows.sysarr,
                    suffered.repeat_interleave(F, dim=0),
                    task_type32=rows.task_type32)
    drop = (act.drop.reshape(B, F, n).gather(
        1, st.site.clamp(0, F - 1)[:, None, :])[:, 0] & (st.site >= 0))
    if fold.block:
        return MapAction(act.assign.reshape(B, M), drop,
                         act.queue_drop.reshape(B, M, Q))
    assign = act.assign.reshape(B, F, M).gather(
        1, fold.owner.expand(B, 1, M))[:, 0]
    queue_drop = act.queue_drop.reshape(B, F, M, Q).gather(
        1, fold.owner[:, None].expand(B, 1, M, Q))[:, 0]
    return MapAction(assign, drop, queue_drop)


def _stage_map(st: SimState, trace: Trace, sysarr: SystemArrays,
               select_fn: Callable, fairness_factor: float, n_types: int,
               fold: Optional[_Fold] = None,
               rows: Optional[_SiteRows] = None,
               types32: Optional[torch.Tensor] = None,
               eet_h: Optional[torch.Tensor] = None, backup_k: int = 0):
    """Run the mapping policy and apply its action; with ``backup_k``,
    nominate the backups of the tasks it queued."""
    action = _map_action(st, trace, sysarr, select_fn, fairness_factor,
                         fold, rows, types32, eet_h)
    st = _apply_action(st, trace, action, n_types)
    if backup_k:
        st = _nominate_backups(st, trace, action, eet_h, backup_k)
    return st


def _nominate_backups(st: SimState, trace: Trace, action: MapAction,
                      eet_h: torch.Tensor, backup_k: int) -> SimState:
    """Record ``backup_k`` backup machines for each task queued this event.

    Per queued task, the healthy machines other than its primary that
    minimize expected completion ``avail_base + EET`` (the health-masked
    EET; the queue backlog is ignored), by repeated masked argmins with
    ties to the lowest machine; ``-1`` where fewer are eligible.
    """
    B, M, Q = st.queue.shape
    n = st.status.shape[1]
    a = action.assign.clamp(min=0)
    ok = (action.assign >= 0) & (st.status.gather(1, a) == QUEUED)
    now = st.now[:, None]
    avail = torch.maximum(
        torch.where(st.run_task >= 0, st.run_end_exp, now), now)
    avail = torch.where(st.alive, avail, BIG)
    score = avail[:, None, :] + type_rows(eet_h, trace.task_type.gather(1, a))
    cols = torch.arange(M, device=a.device)
    score = torch.where(cols == cols[:, None], BIG, score)     # (B, M, M)
    picks = []
    for _ in range(backup_k):
        b = score.argmin(2, keepdim=True)
        has = score.gather(2, b) < BIG
        picks.append(torch.where(ok[:, :, None] & has, b, -1))
        score = torch.where(cols == b, BIG, score)
    backup = torch.cat([st.backup, st.backup[:, :1]], dim=1)
    rows = torch.where(ok, a, n)[:, :, None].expand(B, M, backup_k)
    backup = backup.scatter(1, rows, torch.cat(picks, dim=2))
    return st._replace(backup=backup[:, :n])


def _apply_action(st: SimState, trace: Trace, action, n_types: int):
    """Apply a MapAction: queue evictions, proactive drops, assignments."""
    B, M, Q = st.queue.shape
    n = st.status.shape[1]
    # --- queue evictions (FELARE victims) -> CANCELLED ----------------------
    victim = action.queue_drop & (st.queue >= 0)
    vflat = victim.reshape(B, M * Q)
    qflat = st.queue.reshape(B, M * Q)
    status = set_masked(st.status, qflat, vflat, CANCELLED)
    cancelled = _count_by_type(
        st.cancelled, trace.task_type.gather(1, qflat.clamp(0, n - 1)), vflat)
    # compact queues (stable: keep FCFS order of survivors)
    keep = ~victim & (st.queue >= 0)
    order = torch.argsort((~keep).to(torch.int64), dim=2, stable=True)
    queue = torch.where(keep, st.queue, -1).gather(2, order)
    qlen = keep.sum(dim=2)

    # --- proactive drops from the arriving queue ----------------------------
    drop = action.drop & (status == PENDING)
    status = torch.where(drop, CANCELLED, status)
    cancelled = _count_by_type(cancelled, trace.task_type, drop)

    # --- assignments: append to queue tails ---------------------------------
    assign = action.assign                                        # (B, M)
    tstat = status.gather(1, assign.clamp(min=0))
    ok = (assign >= 0) & (tstat == PENDING) & (qlen < Q)
    slot = qlen.clamp(0, Q - 1)[:, :, None]
    cur = queue.gather(2, slot)[:, :, 0]
    queue = queue.scatter(2, slot, torch.where(ok, assign, cur)[:, :, None])
    qlen = torch.where(ok, qlen + 1, qlen)
    status = set_masked(status, assign, ok, QUEUED)
    return st._replace(status=status, queue=queue, qlen=qlen,
                       cancelled=cancelled)


def _stage_start(st: SimState, trace: Trace, sysarr: SystemArrays,
                 health: bool = False):
    """Idle machines pop their queue head (one pop per machine per event).

    A popped task whose deadline already passed "runs" for zero time with
    success=False and zero energy; the next iteration finalizes it. With
    ``health``, dead machines never pop and stragglers run every task
    ``slowdown`` times longer, in actual and in expected time.
    """
    B, M, Q = st.queue.shape
    now = st.now[:, None]
    can = (st.run_task < 0) & (st.qlen > 0)
    if health:
        can = can & st.alive
    head = torch.where(can, st.queue[:, :, 0], 0)
    ttype = trace.task_type.gather(1, head)
    dl = trace.deadline.gather(1, head)
    e_act = trace.exec_actual.gather(1, head[:, None, :])[:, 0, :]
    e_exp = sysarr.eet[ttype, torch.arange(M, device=head.device)]
    if health:
        fin_act = _fma(e_act, st.slowdown, now)
        fin_exp = _fma(e_exp, st.slowdown, now)
    else:
        fin_act = now + e_act
        fin_exp = now + e_exp
    dead_on_arrival = now >= dl
    end_act = torch.where(dead_on_arrival, now, torch.minimum(fin_act, dl))
    success = ~dead_on_arrival & (fin_act <= dl)
    end_exp = torch.where(dead_on_arrival, now, torch.minimum(fin_exp, dl))
    shifted = torch.cat([st.queue[:, :, 1:], torch.full_like(
        st.queue[:, :, :1], -1)], dim=2)
    return st._replace(
        status=set_masked(st.status, head, can, RUNNING),
        run_task=torch.where(can, head, st.run_task),
        run_start=torch.where(can, now, st.run_start),
        run_end_act=torch.where(can, end_act, st.run_end_act),
        run_end_exp=torch.where(can, end_exp, st.run_end_exp),
        run_success=torch.where(can, success, st.run_success),
        queue=torch.where(can[:, :, None], shifted, st.queue),
        qlen=torch.where(can, st.qlen - 1, st.qlen),
    )


def _fma(a, b, c):
    """``a * b + c`` with one float32 rounding."""
    # repro: allow-f64[the product is exact in float64: one rounding]
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _pick(active: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """``a`` on active replicates, else ``b``."""
    mask = active.reshape(active.shape + (1,) * (a.dim() - 1))
    return torch.where(mask, a, b)


def _freeze(active: torch.Tensor, new: SimState, old: SimState) -> SimState:
    """Keep ``new`` only on active replicates (``vmap``'s frozen carry);
    an absent (``None``) field stays absent."""
    return SimState(*(None if a is None else _pick(active, a, b)
                      for a, b in zip(new, old)))


def _freeze_aux(active: torch.Tensor, new: dict, old: dict) -> dict:
    """:func:`_freeze` over every observer's aux; a leaf no stage
    replaced is kept as it is."""
    return observe.tree_map(
        lambda a, b: a if a is b else _pick(active, a, b), new, old)


def _bind_observers(observers, *, fairness_factor: float, queue_size: int,
                    sites: tuple, tiers: tuple) -> tuple:
    """Resolve names and bind the engine's configuration, as the
    reference's ``make_simulator`` does; refuse duplicate names."""
    bound = tuple(
        ob.with_engine_config(fairness_factor=fairness_factor,
                              queue_size=queue_size, site_of_machine=sites,
                              tier_of_site=tiers)
        for ob in observe.resolve(observers))
    names = [ob.name for ob in bound]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate observer names {names}")
    return bound


def _make_loop(select_fn: Callable, sysarr: SystemArrays, *,
               queue_size: int, fairness_factor: float = 1.0,
               max_steps: int | None = None, dispatcher=None,
               site_of_machine: tuple | None = None,
               observers: tuple = (), dynamics=None, network=None,
               tier_of_site: tuple | None = None) -> Callable:
    """``run(trace) -> (SimState, aux)``: the event loop of
    :func:`make_simulator`, returning the final batched state and each
    observer's finalized result by name (``{}`` with no observers)."""
    S, M = sysarr.eet.shape
    sites = ((0,) * M if site_of_machine is None
             else tuple(int(s) for s in site_of_machine))
    if len(sites) != M:
        raise ValueError(
            f"site_of_machine has {len(sites)} entries for {M} machines")
    n_sites = max(sites) + 1
    tiers = ((0,) * n_sites if tier_of_site is None
             else tuple(int(t) for t in tier_of_site))
    if len(tiers) != n_sites:
        raise ValueError(
            f"tier_of_site has {len(tiers)} entries for {n_sites} sites")
    fold = _make_fold(sysarr, sites) if n_sites > 1 else None
    dispatcher = dispatch.resolve(dispatcher)
    observers = _bind_observers(observers, fairness_factor=fairness_factor,
                                queue_size=queue_size, sites=sites,
                                tiers=tiers)
    gaters = tuple(ob for ob in observers if ob.is_dynamic)
    dynamics = faults.resolve(dynamics)
    if getattr(dynamics, "kind", None) == "none":
        dynamics = None
    network = net_mod.resolve(network)
    if getattr(network, "kind", None) == "none":
        network = None

    def run(trace: Trace, *, metrics: bool = False):
        """``(final state, aux)``; with ``metrics``, its :class:`Metrics`
        third, made inside the ``engine.finish`` span."""
        rec = spans.current()
        if rec is not None:
            rec.open("engine.setup")
        n = trace.arrival.shape[1]
        cap = max_steps if max_steps is not None else 8 * n + 64
        # the two forms of the types, made once: int32 for the kernels,
        # int64 for everything that indexes with them
        types32 = trace.task_type.to(torch.int32).contiguous()
        trace = trace._replace(task_type=trace.task_type.to(torch.int64))
        h = _make_health(dynamics, select_fn, sites, trace)
        backup_k = 0 if h is None else h.backup_k
        wake_ts = None if h is None else h.wake_ts
        net = _make_net(network, tiers, S, trace)
        st = _init_state(trace, M, queue_size, S, n_sites, h is not None,
                         backup_k, 0 if net is None else max(tiers) + 1)
        aux = {ob.name: ob.init(trace, sysarr) for ob in observers}
        rows, max_new = None, 0
        if fold is not None:
            rows = _site_rows(fold, trace, types32)
            max_new = _max_admissions(trace.arrival)
            if h is not None:
                # the orphans of the machines that die at one event
                max_new = min(n, max_new + M * (queue_size + 1))

        def notify(stage, aux, new):
            return {ob.name: ob.on_event(stage, aux[ob.name], new, trace,
                                         sysarr)
                    for ob in observers}

        if rec is not None:
            rec.close()
            rec.start_chain(trace.arrival.device)
        it = 0
        while True:
            if rec is not None:
                rec.begin_iter(COUNTS["loop_iterations"])
            halted = None
            for ob in gaters:
                g = ob.halted(aux[ob.name], st)
                halted = g if halted is None else halted | g
            t = _next_event_time(st, trace, halted, wake_ts)
            active = torch.isfinite(t) & (st.steps < cap)
            t_w = None
            if it % CHECK_EVERY == 0:
                # repro: allow-host[the always-on counters time the check]
                t_c = time.perf_counter_ns()
                if rec is not None:
                    rec.switch("engine.check", t_c)
                # repro: allow-sync[the periodic check, every CHECK_EVERY events]
                done = not bool(active.any())
                # repro: allow-host[the always-on counters time the check]
                t_w = time.perf_counter_ns()
                COUNTS["checks"] += 1
                COUNTS["check_wait_ns"] += t_w - t_c
                # repro: allow-sync[the check's answer, already on the host]
                if done:
                    if rec is not None:
                        rec.drop_iter(t_w)
                    break
            if rec is not None:
                rec.switch("engine.finalize", t_w)
            new = st._replace(now=torch.maximum(t, st.now))
            new = _stage_finalize(new, trace, sysarr)
            new_aux = notify("finalize", aux, new)
            if rec is not None:
                rec.switch("engine.admit")
            new = _stage_admit(new, trace, halted)
            new_aux = notify("admit", new_aux, new)
            eet_h = None
            if h is not None:
                if rec is not None:
                    rec.switch("engine.faults")
                new = _stage_faults(new, trace, sysarr, h)
                new_aux = notify("faults", new_aux, new)
                eet_h = _health_eet(sysarr, new)
            if rec is not None:
                rec.switch("engine.dispatch")
            if fold is not None or net is not None:
                new = _stage_dispatch(new, trace, sysarr, dispatcher, fold,
                                      fairness_factor, max_new, eet_h, net)
            elif h is not None:
                # the flat dispatch: orphans go back to site 0
                new = new._replace(site=new.site.clamp(min=0))
            new_aux = notify("dispatch", new_aux, new)
            if rec is not None:
                rec.switch("engine.map")
            new = _stage_map(new, trace, sysarr, select_fn, fairness_factor,
                             S, fold, rows, types32, eet_h, backup_k)
            new_aux = notify("map", new_aux, new)
            if rec is not None:
                rec.switch("engine.start")
            new = _stage_start(new, trace, sysarr, h is not None)
            new_aux = notify("start", new_aux, new)
            if rec is not None:
                rec.switch("engine.freeze")
            new = new._replace(steps=new.steps + 1)
            st = _freeze(active, new, st)
            aux = _freeze_aux(active, new_aux, aux)
            t_end = None
            if t_w is not None and it > 0:
                # repro: allow-host[the always-on counters time the issue]
                t_end = time.perf_counter_ns()
                COUNTS["issue_ns"] += t_end - t_w
                COUNTS["issue_iters"] += 1
            if rec is not None:
                rec.end_iter(t_end)
            it += 1
            COUNTS["loop_iterations"] += 1
        if rec is not None:
            rec.open("engine.finish")
        out = st, {ob.name: ob.finalize(aux[ob.name], st)
                   for ob in observers}
        if metrics:
            out += (_metrics(st, sysarr),)
        if rec is not None:
            rec.close()
        return out

    return run


def make_simulator(select_fn: Callable, sysarr: SystemArrays, *,
                   queue_size: int, fairness_factor: float = 1.0,
                   max_steps: int | None = None, dispatcher=None,
                   site_of_machine: tuple | None = None,
                   observers: tuple = (), dynamics=None, network=None,
                   tier_of_site: tuple | None = None) -> Callable:
    """Build ``simulate(trace)`` for one mapping policy.

    ``trace`` is a batched :class:`Trace` (leaves (B, N) and (B, N, M))
    on the device of ``sysarr``; results carry the leading B.
    ``select_fn(now, pending, task_type, deadline, view, sysarr,
    suffered)`` is any policy of :mod:`repro_torch.core.policy`.

    ``site_of_machine`` is the static federation partition (``None`` =
    one site) and ``dispatcher`` the :mod:`repro_torch.core.dispatch`
    rule that gives newly-admitted tasks their site (``None`` =
    ``sticky``; unused with one site).

    ``observers`` are :mod:`repro_torch.core.observe` names or
    instances. With ``observers=()`` the simulator returns bare
    :class:`Metrics`; with observers it returns ``(Metrics, aux)``, where
    ``aux`` maps each observer's name to its finalized result.

    ``dynamics`` is the machine-failure process, a registered
    :mod:`repro_torch.core.faults` name or instance. ``None`` or
    ``"none"`` skips the faults stage entirely; any other turns on health
    masking at the dispatch, map and start stages and orphan re-dispatch
    at the ``faults`` stage. A ``with_backup`` policy also nominates
    backups (inert without a dynamics).

    ``network`` is the inter-site cost model, a registered
    :mod:`repro_torch.core.network` name or instance. ``None`` or
    ``"none"`` issues no transfer arithmetic; any other model prices each
    dispatch's ``origin -> site`` link at the dispatch stage. Its tiers
    are ``tier_of_site``, the static (F,) site tiers (``None``: all on
    the device tier), which the observers are bound to as well.
    """
    run = _make_loop(select_fn, sysarr, queue_size=queue_size,
                     fairness_factor=fairness_factor, max_steps=max_steps,
                     dispatcher=dispatcher, site_of_machine=site_of_machine,
                     observers=observers, dynamics=dynamics, network=network,
                     tier_of_site=tier_of_site)

    def simulate(trace: Trace):
        _, aux, metrics = run(trace, metrics=True)
        return (metrics, aux) if observers else metrics

    return simulate


def _metrics(st: SimState, sysarr: SystemArrays) -> Metrics:
    """The :class:`Metrics` of a final batched state.

    The idle energy is summed left to right with an FMA per machine, as
    the reference's compiled sum does up to 8 machines, so it is bit for
    bit the reference's there (past 8 machines XLA vectorizes that sum,
    in an order the port does not mimic; ROADMAP C).
    """
    makespan = st.now
    e_idle = seq_dot(sysarr.p_idle, makespan[:, None] - st.busy_time)
    return Metrics(
        completed_by_type=st.completed,
        missed_by_type=st.missed,
        cancelled_by_type=st.cancelled,
        arrived_by_type=st.arrived,
        energy_dynamic=st.e_dyn,
        energy_wasted=st.e_wasted,
        energy_idle=e_idle,
        makespan=makespan,
    )


def _to_device(trace: Trace, device) -> Trace:
    return Trace(
        arrival=trace.arrival.to(device, torch.float32),
        task_type=trace.task_type.to(device, torch.int32),
        deadline=trace.deadline.to(device, torch.float32),
        exec_actual=trace.exec_actual.to(device, torch.float32),
    )


def _resolve_policy(heuristic, use_fused_map: bool, use_fused_phase1: bool):
    from repro_torch.core import policy

    pol = policy.get(heuristic) if isinstance(heuristic, str) else heuristic
    if use_fused_phase1:
        pol = policy.with_fused_phase1(pol)
    if use_fused_map:
        pol = policy.with_fused_map(pol)
    return pol


def _resolve_dispatcher(dispatcher, use_fused_map: bool):
    disp = dispatch.resolve(dispatcher)
    return dispatch.with_fused_balance(disp) if use_fused_map else disp


def simulate_batch(traces: Trace, spec, heuristic, *, observers=(),
                   max_steps=None, dispatcher=None, dynamics=None,
                   network=None, use_fused_map: bool = False,
                   use_fused_phase1: bool = False, device=None):
    """Simulate a batch of traces (leaves (B, N), (B, N, M)) under one
    heuristic (a registered name or a policy object) on ``device``
    (``None`` = the CUDA device). Returns Metrics with leading B, or
    ``(Metrics, aux)`` when ``observers`` (names or instances) are
    attached.

    ``spec.site_of_machine`` (if set) partitions the machines into sites
    served through ``dispatcher`` (a registered name or a dispatcher;
    ``None`` = ``sticky``). ``dynamics`` (a registered name or instance;
    ``None`` = ``"none"``) injects machine failures at the ``faults``
    stage. ``network`` (a registered name or instance; ``None`` =
    ``"none"``) prices inter-site dispatch over ``spec.tier_of_site``.
    ``use_fused_map`` runs the map decision and the dispatcher's balance
    walk through the kernels.
    """
    dev = resolve_device(device)
    net = net_mod.resolve(network)
    # as the reference: observers see the tiers only with a network
    tiers = None if getattr(net, "kind", None) == "none" else spec.tiers
    sim = make_simulator(
        _resolve_policy(heuristic, use_fused_map, use_fused_phase1),
        spec.as_torch(dev), queue_size=spec.queue_size,
        fairness_factor=float(spec.fairness_factor), max_steps=max_steps,
        dispatcher=_resolve_dispatcher(dispatcher, use_fused_map),
        site_of_machine=spec.site_of_machine, observers=observers,
        dynamics=dynamics, network=net, tier_of_site=tiers)
    return sim(_to_device(traces, dev))


def simulate(trace: Trace, spec, heuristic, *, observers=(), max_steps=None,
             dispatcher=None, dynamics=None, network=None,
             use_fused_map: bool = False, use_fused_phase1: bool = False,
             device=None):
    """One trace (leaves (N,), (N, M)), one SystemSpec, one heuristic:
    Metrics, or ``(Metrics, aux)`` with observers, without the batch dim."""
    batched = Trace(*(x[None] for x in trace))
    out = simulate_batch(batched, spec, heuristic, observers=observers,
                         max_steps=max_steps, dispatcher=dispatcher,
                         dynamics=dynamics, network=network,
                         use_fused_map=use_fused_map,
                         use_fused_phase1=use_fused_phase1, device=device)
    return observe.tree_map(lambda x: x[0], out)
