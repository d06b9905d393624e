"""The plain reference: one trace through the paper's event loop, in numpy.

A frozen rewrite, after the pattern of the reference package's
plain-loop oracle, of what the benchmark's cells run: the flat system and
the federation, ELARE and FELARE (Sec. IV-V of arXiv:2206.00065), the
``sticky`` and ``fair_spill`` dispatchers. It imports nothing of the
program under test. Everything the program derives (each task's EET
row, the machines' availability, feasibility, Eq. 3's fairness limit,
the dispatch walk) is worked out again here from the trace and the
configuration file's tables.

One event, in order: finalize the runs that ended, admit the arrivals,
dispatch the new tasks to sites, map each site's pending tasks, start
each idle machine's queue head. The next event is the earliest of the
next arrival, the next end of a run and the earliest pending deadline.

Trace times are dyadic, so event times are exact in any float format
wide enough to hold them. The decision arithmetic (availability sums,
feasibility, energy keys, the fairness limit) is float32 with one
rounding per operation, in the order the paper's equations give; the
reported energies are accumulated in float64. ``precision="bfloat16"``
rounds every float32 value, and every result of that arithmetic, the
energies and the trace's own times to bfloat16 instead: the control
that a sound comparison has to reject.
"""
from __future__ import annotations

import math

import numpy as np

BIG = np.float32(1e30)
HASH_MUL = 2654435761
MASK32 = 0xFFFFFFFF
F32 = np.float32


def bf16(x):
    """float32 values rounded to the nearest bfloat16 (ties to even),
    kept as float32."""
    a = np.asarray(x, F32)
    u = a.view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    out = u.astype(np.uint32).view(F32)
    return out if out.ndim else out[()]


class Arith:
    """The rounding of the decision arithmetic: float32 or bfloat16."""

    def __init__(self, precision: str):
        if precision not in ("float32", "bfloat16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.low = precision == "bfloat16"

    def r(self, x):
        """``x`` rounded to the working format (a float32 value)."""
        return bf16(x) if self.low else F32(x)

    def ra(self, x):
        """An array rounded to the working format (float32 arrays)."""
        return bf16(x) if self.low else np.asarray(x, F32)

    def acc(self, total: float, add: float) -> float:
        """An energy accumulation: float64, or bfloat16 in the control."""
        return float(bf16(F32(total + add))) if self.low else total + add


def fairness_limit(cr, fairness_factor, ar: Arith):
    """Eq. 3, eps = mu - f sigma over the per-type completion rates
    (float32): the mean and the sum of squares left to right, each square
    fused into its accumulation, times the float32 reciprocal of the
    count; sigma correctly rounded; clamped at 0."""
    S = len(cr)
    inv = F32(1.0 / S)
    total = cr[0]
    for i in range(1, S):
        total = ar.r(total + cr[i])
    mu = ar.r(total * inv)
    acc = F32(0.0)
    for i in range(S):
        c = float(ar.r(cr[i] - mu))
        acc = ar.r(c * c + float(acc))
    sigma = ar.r(math.sqrt(float(ar.r(acc * inv))))
    f = float(F32(fairness_factor))
    eps = ar.r(float(mu) - f * float(sigma))
    return max(eps, F32(0.0))


def suffered_types(completed, arrived, fairness_factor, ar: Arith):
    """Algorithm 4: the types whose completion rate is at or below Eq. 3's
    limit, among those with an arrival."""
    cr = np.where(arrived > 0,
                  ar.ra(completed.astype(F32)
                        / np.maximum(arrived, 1).astype(F32)),
                  F32(1.0)).astype(F32)
    cr = ar.ra(cr)
    eps = fairness_limit(cr, fairness_factor, ar)
    return (cr <= eps) & (arrived >= 1)


class System:
    """The configuration's tables, as the reference reads them."""

    def __init__(self, cfg: dict):
        self.eet = np.asarray(cfg["eet"], F32)
        self.p_dyn = np.asarray(cfg["p_dyn"], F32)
        self.p_idle = np.asarray(cfg["p_idle"], F32)
        self.queue_size = int(cfg["queue_size"])
        self.fairness_factor = float(cfg["fairness_factor"])
        S, M = self.eet.shape
        sites = cfg.get("site_of_machine")
        self.sites = np.zeros(M, np.int64) if sites is None else \
            np.asarray(sites, np.int64)
        self.n_sites = int(self.sites.max()) + 1
        self.site_machines = [np.flatnonzero(self.sites == s)
                              for s in range(self.n_sites)]


def _completion(s, e, d):
    """Eq. 1: the expected completion of a task started at ``s``."""
    if s + e <= d:
        return s + e
    if s < d:
        return d
    return s


def simulate(trace: dict, system: System, policy: str,
             dispatcher: str = "sticky", precision: str = "float32",
             max_steps: int | None = None) -> dict:
    """Run one trace; return its per-type counters, energies, makespan and
    the number of events.

    ``trace``: ``arrival`` (N,), ``task_type`` (N,), ``deadline`` (N,),
    ``exec_actual`` (N, M), arrival-sorted. ``policy``: ``"ELARE"`` or
    ``"FELARE"``. ``dispatcher``: ``"sticky"`` (a salted multiplicative
    hash of the task index, salt 0) or ``"fair_spill"`` (suffered types
    to the least-loaded site, in task order, the others home); it only
    acts on a federation. The loop stops after ``max_steps`` events
    (``8 N + 64`` by default), as the program's does.
    """
    if policy not in ("ELARE", "FELARE"):
        raise ValueError(f"the reference has no policy {policy!r}")
    if dispatcher not in ("sticky", "fair_spill"):
        raise ValueError(f"the reference has no dispatcher {dispatcher!r}")
    fair = policy == "FELARE"
    ar = Arith(precision)
    eet = ar.ra(system.eet)
    p_dyn = ar.ra(system.p_dyn)
    p_idle = ar.ra(system.p_idle)
    S, M = eet.shape
    Q = system.queue_size
    n_sites = system.n_sites
    site_machines = system.site_machines
    eet_min_site = np.stack([eet[:, ms].min(axis=1) for ms in site_machines],
                            axis=1)                                # (S, F)

    def times(x):
        x = np.asarray(x, F32)
        return (bf16(x) if ar.low else x).astype(np.float64)

    arr = times(trace["arrival"])
    dl = times(trace["deadline"])
    dl32 = dl.astype(F32)
    ttype = np.asarray(trace["task_type"], np.int64)
    exec_act = times(trace["exec_actual"])
    n = len(arr)
    eet_rows = eet[ttype]                                          # (N, M)

    completed = np.zeros(S, np.int64)
    missed = np.zeros(S, np.int64)
    cancelled = np.zeros(S, np.int64)
    arrived = np.zeros(S, np.int64)
    run = np.full(M, -1, np.int64)
    run_start = np.zeros(M)
    run_end_act = np.full(M, np.inf)
    run_end_exp = np.zeros(M, F32)
    run_success = np.zeros(M, bool)
    busy = np.zeros(M)
    queues = [[] for _ in range(M)]
    pend = [[] for _ in range(n_sites)]   # per site, ascending task index
    e_dyn = 0.0
    e_wasted = 0.0
    now = 0.0
    a_ptr = 0

    def cancel(k):
        cancelled[ttype[k]] += 1

    def avail_vec(ms, now32):
        """Each machine's expected start time for a new task: the end of
        its run (or now), plus its queue's EETs left to right."""
        out = np.empty(len(ms), F32)
        for i, j in enumerate(ms):
            base = ar.r(max(now32, run_end_exp[j])) if run[j] >= 0 else now32
            qs = F32(0.0)
            for k in queues[j]:
                qs = ar.r(qs + eet[ttype[k], j])
            out[i] = ar.r(base + qs)
        return out

    def map_site(s, suffered, now32):
        ms = site_machines[s]
        tasks = pend[s]
        # stale purge: a pending task past its deadline is never nominated
        keep = []
        for k in tasks:
            if now >= dl[k]:
                cancel(k)
            else:
                keep.append(k)
        tasks[:] = keep
        if not tasks:
            return
        idx = np.asarray(tasks, np.int64)
        E = eet_rows[idx][:, ms]                                   # (P, m)
        d = dl32[idx]
        hopeless = ar.ra(now32 + eet_min_site[ttype[idx], s]) > d
        suff_task = suffered[ttype[idx]]
        if fair and suff_task.any():
            avail = avail_vec(ms, now32)
            qfree = np.asarray([len(queues[j]) < Q for j in ms])
            feas_now = ((ar.ra(avail[None, :] + E) <= d[:, None])
                        & qfree[None, :]).any(axis=1)
            resc = suff_task & ~feas_now & ~hopeless
            if resc.any():
                cand = np.flatnonzero(resc)
                t = cand[np.argmin(d[cand])]                       # first
                i_star = int(np.argmin(ar.ra(avail + E[t])))
                j = int(ms[i_star])
                e_tgt = E[t, i_star]
                base = ar.r(max(now32, run_end_exp[j])) if run[j] >= 0 \
                    else now32
                rem = F32(0.0)
                for q in queues[j]:
                    rem = ar.r(rem + eet[ttype[q], j])
                evict = []
                for qi in range(len(queues[j]) - 1, -1, -1):
                    if ar.r(ar.r(base + rem) + e_tgt) <= d[t]:
                        break
                    v = queues[j][qi]
                    if not suffered[ttype[v]]:
                        evict.append(qi)
                        rem = ar.r(rem - eet[ttype[v], j])
                if ar.r(ar.r(base + rem) + e_tgt) <= d[t]:
                    for qi in evict:            # tail first: indices hold
                        cancel(queues[j].pop(qi))
        # Phase I on the post-eviction state: each task's feasible machine
        # of least expected energy (Eq. 2), the first on ties
        avail = avail_vec(ms, now32)
        qfree = np.asarray([len(queues[j]) < Q for j in ms])
        feas = (ar.ra(avail[None, :] + E) <= d[:, None]) & qfree[None, :]
        ec = np.where(feas, ar.ra(p_dyn[ms][None, :] * E), BIG)
        best = np.argmin(ec, axis=1)
        best_ec = ec[np.arange(len(idx)), best]
        nominated = best_ec < BIG
        # Phase II: each free machine takes its nominee of least energy
        # (lowest index on ties); under FELARE the suffered types' nominees
        # claim machines first and the rest serve the others
        assign = {}
        pools = [suff_task, ~suff_task] if fair else [np.ones_like(nominated)]
        for pool in pools:
            for i in range(len(ms)):
                if i in assign or not qfree[i]:
                    continue
                cand = np.flatnonzero(nominated & pool & (best == i))
                if cand.size:
                    assign[i] = int(cand[np.argmin(best_ec[cand])])
        taken = set(assign.values())
        # ELARE's proactive drop of the hopeless tasks not mapped now
        left = []
        for t, k in enumerate(tasks):
            if t in taken:
                continue
            if hopeless[t]:
                cancel(k)
            else:
                left.append(k)
        for i, t in assign.items():
            k = tasks[t]
            queues[ms[i]].append(k)
        tasks[:] = left

    cap = max_steps if max_steps is not None else 8 * n + 64
    steps = 0
    while steps < cap:
        t_next = arr[a_ptr] if a_ptr < n else np.inf
        running = run >= 0
        if running.any():
            t_next = min(t_next, run_end_act[running].min())
        for tasks in pend:
            if tasks:
                t_next = min(t_next, dl[tasks].min())
        if not np.isfinite(t_next):
            break
        now = max(now, float(t_next))
        steps += 1
        # finalize the runs that ended
        for j in np.flatnonzero(running & (run_end_act <= now)):
            k = run[j]
            dur = run_end_act[j] - run_start[j]
            en = float(p_dyn[j]) * dur
            e_dyn = ar.acc(e_dyn, en)
            busy[j] += dur
            if run_success[j]:
                completed[ttype[k]] += 1
            else:
                missed[ttype[k]] += 1
                e_wasted = ar.acc(e_wasted, en)
            run[j] = -1
            run_end_act[j] = np.inf
            run_end_exp[j] = F32(now)
        # admit the arrivals
        first = a_ptr
        while a_ptr < n and arr[a_ptr] <= now:
            arrived[ttype[a_ptr]] += 1
            a_ptr += 1
        new = range(first, a_ptr)
        # dispatch each new task to a site, once
        if n_sites == 1:
            for k in new:
                pend[0].append(k)
        elif len(new):
            spill = None
            if dispatcher == "fair_spill":
                spill = suffered_types(completed, arrived,
                                       system.fairness_factor, ar)
                load = np.asarray(
                    [sum(len(queues[j]) + (run[j] >= 0) for j in ms)
                     for ms in site_machines], np.int64)
            for k in new:
                home = ((k * HASH_MUL) & MASK32) % n_sites
                if spill is not None:
                    s = int(np.argmin(load)) if spill[ttype[k]] else home
                    load[s] += 1
                else:
                    s = home
                pend[s].append(k)
        # map each site's pending tasks
        now32 = ar.r(now)
        suffered = suffered_types(completed, arrived, system.fairness_factor,
                                  ar)
        for s in range(n_sites):
            if pend[s]:
                map_site(s, suffered, now32)
        # each idle machine starts its queue head
        for j in range(M):
            if run[j] >= 0 or not queues[j]:
                continue
            k = queues[j].pop(0)
            run[j] = k
            run_start[j] = now
            if now >= dl[k]:
                run_success[j] = False
                run_end_act[j] = now
                run_end_exp[j] = F32(now)
            else:
                fin = now + exec_act[k, j]
                run_success[j] = fin <= dl[k]
                run_end_act[j] = min(fin, dl[k])
                run_end_exp[j] = ar.r(_completion(now32, eet[ttype[k], j],
                                                  dl32[k]))
    makespan = now
    e_idle = 0.0
    for j in range(M):
        e_idle = ar.acc(e_idle, float(p_idle[j]) * (makespan - busy[j]))
    return dict(completed_by_type=completed, missed_by_type=missed,
                cancelled_by_type=cancelled, arrived_by_type=arrived,
                energy_dynamic=e_dyn, energy_wasted=e_wasted,
                energy_idle=e_idle, makespan=makespan, steps=steps)
