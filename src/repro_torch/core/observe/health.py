"""Fleet-health telemetry observer, ``health`` (counterpart of
``repro/core/observe/health.py``).

Samples the faults subsystem's per-machine health
(:mod:`repro_torch.core.faults`) into K uniform time buckets over each
replicate's horizon, like :class:`~repro_torch.core.observe.timeline.
Timeline`: healthy machine counts (fleet-wide and per site), the site
heartbeat mask the ``health_aware`` dispatcher reads, and the cumulative
orphan pressure failures put on the workload. With no dynamics attached
the series are flat (every machine alive, no orphans), so the observer
composes with any run.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.observe.base import Observer, write_bucket
from repro_torch.core.observe.timeline import (
    _bucket_mask,
    _finalize_series,
    _series_init,
)

_SERIES = ("healthy", "site_healthy", "site_alive", "orphans", "retried")


@dataclasses.dataclass(frozen=True)
class Health(Observer):
    """K-bucket machine/site health and orphan-pressure series.

    Result tree (leaves lead with B, then the K=``n_buckets`` axis):
      ``t``            (B, K)    right edge of each bucket (seconds)
      ``healthy``      (B, K)    alive machines at the last event <= t
      ``site_healthy`` (B, K, F) alive machines per federation site
      ``site_alive``   (B, K, F) heartbeat mask: site has >= 1 healthy
                                 machine
      ``orphans``      (B, K)    cumulative orphan re-dispatches (the sum
                                 of the per-task retry counters)
      ``retried``      (B, K)    tasks orphaned at least once so far
      ``horizon``      (B,)      the sampled time horizon (max deadline)

    The F axis sizes from the engine-bound site partition; flat systems
    get F = 1.
    """

    n_buckets: int = 64
    name: str = "health"
    site_of_machine: tuple | None = None  # engine-bound, not serialized

    def with_engine_config(self, *, site_of_machine=None, **config):
        if site_of_machine is None:
            return self
        return dataclasses.replace(
            self, site_of_machine=tuple(int(s) for s in site_of_machine))

    def _sites(self, n_machines: int) -> tuple:
        return self.site_of_machine or (0,) * n_machines

    def init(self, trace, sysarr):
        K, M = self.n_buckets, sysarr.eet.shape[1]
        sites = self._sites(M)
        F = max(sites) + 1
        aux = _series_init(trace, K)
        B, dev = aux["horizon"].shape[0], trace.arrival.device

        def zeros(shape, dtype):
            return torch.zeros((B, K) + shape, dtype=dtype, device=dev)

        i32 = torch.int32
        aux.update(healthy=zeros((), i32), site_healthy=zeros((F,), i32),
                   site_alive=zeros((F,), torch.bool),
                   orphans=zeros((), i32), retried=zeros((), i32),
                   site_ids=torch.tensor(sites, device=dev).expand(B, M))
        return aux

    def on_event(self, stage, aux, st, trace, sysarr):
        if stage != "start":  # sample once per event, at end-of-event state
            return aux
        hot = _bucket_mask(aux, st.now, self.n_buckets)
        i32 = torch.int32
        B, M = st.run_task.shape
        F = aux["site_healthy"].shape[2]
        alive = (torch.ones((B, M), dtype=torch.int64, device=hot.device)
                 if st.alive is None else st.alive.to(torch.int64))
        site_healthy = torch.zeros((B, F), dtype=torch.int64,
                                   device=hot.device).scatter_add(
            1, aux["site_ids"], alive)
        if st.retries is None:
            orphans = retried = torch.zeros(B, dtype=i32, device=hot.device)
        else:
            orphans = st.retries.sum(1).to(i32)
            retried = (st.retries > 0).sum(1).to(i32)
        values = {"healthy": alive.sum(1).to(i32),
                  "site_healthy": site_healthy.to(i32),
                  "site_alive": site_healthy > 0,
                  "orphans": orphans, "retried": retried}
        out = {**aux, "touched": aux["touched"] | hot}
        for k, v in values.items():
            out[k] = write_bucket(aux[k], hot, v)
        return out

    def finalize(self, aux, st):
        sites = torch.tensor(self._sites(st.run_task.shape[1]))
        per_site = torch.bincount(sites).to(torch.int32)
        zero = torch.zeros((), dtype=torch.int32)
        init = {"healthy": per_site.sum().to(torch.int32),
                "site_healthy": per_site, "site_alive": per_site > 0,
                "orphans": zero, "retried": zero}
        return _finalize_series(aux, {k: aux[k] for k in _SERIES}, init,
                                self.n_buckets)

    def to_json_dict(self) -> dict:
        return {"kind": "health", "n_buckets": self.n_buckets,
                "name": self.name}
