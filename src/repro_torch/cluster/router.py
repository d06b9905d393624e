"""FELARE as the request router of the serving runtime (counterpart of
``repro/cluster/router.py``).

The router owns per-machine bounded local queues, the EET matrix (seeded
from the roofline model and refined online by an EMA of observed
latencies, so a slow machine's row grows and FELARE routes around it
while the suffered-type priority prevents starvation), per-type
completion tracking and the energy ledger.

``Router.on_request`` / ``on_completion`` are the paper's mapping
events. The bookkeeping is the reference's, in numpy. The decision is
the port's batched policy, resolved by name through
:func:`repro_torch.core.policy.get` (so a registered
``with_fused_map(...)`` or ``with_fused_phase1(...)`` drives the router
through the kernels), called on a batch of one event on the router's
device; the suffered-type mask, Jain's index and Eq. 1's completion
time are the port's torch functions on that device too.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from repro_torch.core import equations, fairness, policy
from repro_torch.core.device import resolve_device
from repro_torch.core.policy import MachineView
from repro_torch.core.types import SystemArrays


@dataclasses.dataclass
class Request:
    rid: int
    task_type: int
    arrival: float
    deadline: float
    payload: object = None
    # lifecycle
    machine: int | None = None
    start: float | None = None
    finish: float | None = None
    status: str = "pending"   # pending|queued|running|completed|missed|cancelled


class Router:
    """``device``: where the policy runs (``None`` = CUDA; raises without
    a card). ``map_calls`` counts the events that called the policy,
    ``map_tasks`` the tasks (pending and queued) they mapped over, and
    ``map_seconds`` their host time, tensors built and action read back
    included."""

    def __init__(self, eet: np.ndarray, p_dyn, p_idle, *, queue_size=2,
                 heuristic: str = "FELARE", fairness_factor: float = 1.0,
                 eet_ema: float = 0.2,
                 now_fn: Callable[[], float] = time.monotonic, device=None):
        self.device = resolve_device(device)
        self.eet = np.asarray(eet, np.float32).copy()
        self.p_dyn = np.asarray(p_dyn, np.float32)
        self.p_idle = np.asarray(p_idle, np.float32)
        self.S, self.M = self.eet.shape
        self.Q = queue_size
        self.heuristic = policy.get(heuristic)
        self.f = fairness_factor
        self.ema = eet_ema
        self.now_fn = now_fn

        self.pending: dict[int, Request] = {}
        self.queues: list[deque[Request]] = [deque() for _ in range(self.M)]
        self.running: list[Request | None] = [None] * self.M
        self.run_end_exp = np.zeros(self.M, np.float64)
        self.completed = np.zeros(self.S, np.int64)
        self.missed = np.zeros(self.S, np.int64)
        self.cancelled = np.zeros(self.S, np.int64)
        self.arrived = np.zeros(self.S, np.int64)
        self.energy = 0.0
        self.energy_wasted = 0.0
        self.map_calls = 0
        self.map_tasks = 0
        self.map_seconds = 0.0
        self._p_dyn_t = self._tensor(self.p_dyn)
        self._p_idle_t = self._tensor(self.p_idle)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------------
    def on_request(self, req: Request):
        self.pending[req.rid] = req
        self.arrived[req.task_type] += 1
        return self._map_event()

    def on_completion(self, machine: int, *, success: bool, latency: float):
        req = self.running[machine]
        if req is None:
            raise ValueError(f"machine {machine} runs no request")
        now = self.now_fn()
        req.finish = now
        req.status = "completed" if success else "missed"
        dur = now - (req.start if req.start is not None else now)
        e = self.p_dyn[machine] * dur
        self.energy += e
        if success:
            self.completed[req.task_type] += 1
        else:
            self.missed[req.task_type] += 1
            self.energy_wasted += e
        # EET EMA refresh -> straggler adaptation
        i, j = req.task_type, machine
        self.eet[i, j] = ((1 - self.ema) * self.eet[i, j]
                          + self.ema * latency)
        self.running[machine] = None
        started = self._start_tasks()
        return self._map_event() + started

    # ------------------------------------------------------------------
    def _suffered(self) -> torch.Tensor:
        """(1, S) bool suffered-type mask on the router's device."""
        counts = self._tensor(np.stack([self.completed, self.arrived])
                              .astype(np.float32))
        return fairness.suffered_types(counts[0:1], counts[1:2], self.f)

    def _map_event(self):
        """Run one mapping event over the live pending set. Returns newly
        started requests (machine, Request) for the executor to launch."""
        now = self.now_fn()
        pend_list = list(self.pending.values())
        queued_reqs = [r for q in self.queues for r in q]
        allr = pend_list + queued_reqs
        n = len(allr)
        if n == 0:
            return self._start_tasks()
        t0 = time.perf_counter()
        ttype = np.array([[r.task_type for r in allr]], np.int64)
        deadline = np.array([[r.deadline for r in allr]], np.float32)
        pending_mask = np.array([[r.status == "pending" for r in allr]])
        # id -> flat index map: O(n) once; a dataclass Request compares
        # by value, so list.index could resolve to an equal other one.
        idx_of = {id(r): k for k, r in enumerate(allr)}
        queue = np.full((1, self.M, self.Q), -1, np.int64)
        for j, q in enumerate(self.queues):
            for s, req in enumerate(q):
                queue[0, j, s] = idx_of[id(req)]
        avail = np.where(
            [r is not None for r in self.running],
            np.maximum(self.run_end_exp, now), now).astype(np.float32)
        ttype_t = self._tensor(ttype)
        view = MachineView(
            avail_base=self._tensor(avail[None]),
            queue=self._tensor(queue),
            qlen=self._tensor(np.array([[len(q) for q in self.queues]],
                                       np.int64)),
        )
        sysarr = SystemArrays(eet=self._tensor(self.eet), p_dyn=self._p_dyn_t,
                              p_idle=self._p_idle_t)
        action = self.heuristic(
            self._tensor(np.array([now], np.float32)),
            self._tensor(pending_mask), ttype_t, self._tensor(deadline),
            view, sysarr, self._suffered(), ttype_t.to(torch.int32))
        qd, drops, assign = (a[0].cpu().numpy() for a in (
            action.queue_drop, action.drop, action.assign))
        self.map_calls += 1
        self.map_tasks += n
        self.map_seconds += time.perf_counter() - t0

        # queue evictions
        for j in range(self.M):
            victims = [s for s in range(self.Q)
                       if s < len(self.queues[j]) and qd[j, s]]
            for s in reversed(victims):
                victim = self.queues[j][s]
                del self.queues[j][s]
                victim.status = "cancelled"
                self.cancelled[victim.task_type] += 1
        # drops
        for k, r in enumerate(allr):
            if k < len(pend_list) and drops[k] and r.status == "pending":
                r.status = "cancelled"
                self.cancelled[r.task_type] += 1
                self.pending.pop(r.rid, None)
        # assignments
        for j in range(self.M):
            k = int(assign[j])
            if k < 0 or k >= len(allr):
                continue
            r = allr[k]
            if r.status == "pending" and len(self.queues[j]) < self.Q:
                r.status = "queued"
                r.machine = j
                self.queues[j].append(r)
                self.pending.pop(r.rid, None)
        return self._start_tasks()

    def _completion_time(self, now, exec_time, deadline) -> float:
        """Eq. 1 in float32 on the router's device."""
        s, e, d = self._tensor(np.array([now, exec_time, deadline],
                                        np.float32))
        return float(equations.completion_time(s, e, d))

    def _start_tasks(self):
        """Pop queue heads onto idle machines; returns [(machine, Request)]."""
        now = self.now_fn()
        started = []
        for j in range(self.M):
            while self.running[j] is None and self.queues[j]:
                req = self.queues[j].popleft()
                if now >= req.deadline:
                    req.status = "missed"
                    self.missed[req.task_type] += 1
                    continue
                req.status = "running"
                req.start = now
                self.running[j] = req
                self.run_end_exp[j] = self._completion_time(
                    now, self.eet[req.task_type, j], req.deadline)
                started.append((j, req))
        return started

    # ------------------------------------------------------------------
    def metrics(self):
        cr = np.where(self.arrived > 0,
                      self.completed / np.maximum(self.arrived, 1), 1.0)
        return {
            "completed": self.completed.copy(),
            "missed": self.missed.copy(),
            "cancelled": self.cancelled.copy(),
            "arrived": self.arrived.copy(),
            "completion_rate_by_type": cr,
            "collective_completion_rate":
                float(self.completed.sum() / max(self.arrived.sum(), 1)),
            "jain_fairness": float(fairness.jain_index(
                self._tensor(cr.astype(np.float32)))),
            "energy": self.energy,
            "energy_wasted": self.energy_wasted,
            "eet": self.eet.copy(),
        }
