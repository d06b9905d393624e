"""Per-task event log observer, ``task_log`` (counterpart of
``repro/core/observe/tasklog.py``).

Records, for every task of every replicate, the times of its lifecycle
transitions and where it ran, stamp-once: a field is written at the
first event whose stage shows the transition and never overwritten.

Every stage of one event shares its ``now``, so a stamp taken at any
stage of the event that made a transition has the same value. The log
therefore stamps each field at the stage that ends the event's chance to
make it: ``map_time`` at ``map`` (the only stage that queues a task;
a task queued and started in one event is QUEUED only there), and
``start_time``, ``end_time`` and ``machine`` at ``start`` (RUNNING is set
only there, and a terminal status, whether set at ``finalize``,
``admit``, ``faults`` or ``map``, is still there at ``start``). A task
that a failover queues at ``faults`` was running before, so it was mapped
already. ``machine`` is the last machine the task started on.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.observe.base import Observer
from repro_torch.core.policy.base import set_masked
from repro_torch.core.types import COMPLETED, QUEUED, RUNNING, UNARRIVED


def _stamp(t: torch.Tensor, mask: torch.Tensor, now: torch.Tensor):
    return torch.where(mask & (t < 0), now[:, None], t)


@dataclasses.dataclass(frozen=True)
class TaskLog(Observer):
    """Result tree (all (B, N)):

      ``map_time``   f32, when the task was assigned to a local queue
                     (−1 = never mapped)
      ``start_time`` f32, when it started executing (−1 = never started)
      ``end_time``   f32, when it reached a terminal status (−1 = never)
      ``machine``    int32, the machine it ran on (−1 = none)
      ``site``       int32, the federation site it was dispatched to
                     (−1 = never dispatched; 0 on single-site systems)
      ``status``     int32, final status code
      ``retries``    int32, orphan re-dispatches the task suffered from
                     machine failures (0 with no dynamics attached)
      ``ready_time`` f32, when the task landed at its dispatched site
                     (its arrival until dispatched; −1 throughout with
                     no network attached)
    """

    name: str = "task_log"
    summary = ("Per-task map/start/end times, final status and machine "
               "(oracle-checkable)")

    def init(self, trace, sysarr):
        shape = trace.arrival.shape
        dev = trace.arrival.device

        def full(value, dtype):
            return torch.full(shape, value, dtype=dtype, device=dev)

        return {
            "map_time": full(-1.0, torch.float32),
            "start_time": full(-1.0, torch.float32),
            "end_time": full(-1.0, torch.float32),
            "machine": full(-1, torch.int64),
        }

    def on_event(self, stage, aux, st, trace, sysarr):
        if stage == "map":
            return {**aux, "map_time": _stamp(aux["map_time"],
                                              st.status == QUEUED, st.now)}
        if stage != "start":
            return aux
        busy = st.run_task >= 0
        machines = torch.arange(busy.shape[1], device=busy.device)
        return {
            "map_time": aux["map_time"],
            "start_time": _stamp(aux["start_time"], st.status == RUNNING,
                                 st.now),
            "end_time": _stamp(aux["end_time"], st.status >= COMPLETED,
                               st.now),
            "machine": set_masked(aux["machine"], st.run_task, busy,
                                  machines.expand_as(st.run_task)),
        }

    def finalize(self, aux, st):
        i32 = torch.int32
        # a task never admitted was never dispatched: the reference gives
        # it site -1 on every system, where the flat port starts at 0
        site = torch.where(st.status == UNARRIVED, -1, st.site)
        return {
            "map_time": aux["map_time"],
            "start_time": aux["start_time"],
            "end_time": aux["end_time"],
            "machine": aux["machine"].to(i32),
            "site": site.to(i32),
            "status": st.status.to(i32),
            "retries": (torch.zeros_like(st.status, dtype=i32)
                        if st.retries is None else st.retries.to(i32)),
            "ready_time": (torch.full_like(aux["map_time"], -1.0)
                           if st.ready is None else st.ready),
        }

    def to_json_dict(self) -> dict:
        return {"kind": "task_log", "name": self.name}
