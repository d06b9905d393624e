"""Edge-cloud network telemetry observer, ``network`` (counterpart of
``repro/core/observe/network.py``).

Samples the network subsystem's transfer state
(:mod:`repro_torch.core.network`) into K uniform time buckets over each
replicate's horizon, like :class:`~repro_torch.core.observe.health.
Health`: per-tier queued + running load, the cumulative transfer energy
charged per destination tier, and the count of tasks in transit. With
no network attached the series are flat (no transfer energy, nothing in
transit), so the observer composes with any run.
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
from repro_torch.core.types import PENDING

_SERIES = ("tier_load", "xfer_energy", "in_transit")


@dataclasses.dataclass(frozen=True)
class Network(Observer):
    """K-bucket per-tier load and transfer-energy series.

    Result tree (leaves lead with B, then the K=``n_buckets`` axis):
      ``t``           (B, K)    right edge of each bucket (seconds)
      ``tier_load``   (B, K, T) queued + running tasks on each tier's
                                machines at the last event <= t
      ``xfer_energy`` (B, K, T) cumulative transfer energy charged to
                                links landing on each tier (joules)
      ``in_transit``  (B, K)    dispatched tasks still paying link latency
      ``horizon``     (B,)      the sampled time horizon (max deadline)

    The T axis sizes from the engine-bound tier partition; a run without
    a network, or an untiered fleet, gets T = 1.
    """

    n_buckets: int = 64
    name: str = "network"
    site_of_machine: tuple | None = None  # engine-bound, not serialized
    tier_of_site: tuple | None = None     # engine-bound, not serialized

    def with_engine_config(self, *, site_of_machine=None, tier_of_site=None,
                           **config):
        ob = self
        if site_of_machine is not None:
            ob = dataclasses.replace(
                ob, site_of_machine=tuple(int(s) for s in site_of_machine))
        if tier_of_site is not None:
            ob = dataclasses.replace(
                ob, tier_of_site=tuple(int(t) for t in tier_of_site))
        return ob

    @property
    def _n_tiers(self) -> int:
        return 1 if self.tier_of_site is None else max(self.tier_of_site) + 1

    def _tier_ids(self, n_machines: int) -> list:
        """The tier of each machine, through its site."""
        sites = self.site_of_machine or (0,) * n_machines
        tiers = self.tier_of_site or (0,) * (max(sites) + 1)
        return [tiers[s] for s in sites]

    def init(self, trace, sysarr):
        K, T, M = self.n_buckets, self._n_tiers, sysarr.eet.shape[1]
        aux = _series_init(trace, K)
        B, dev = aux["horizon"].shape[0], trace.arrival.device

        def zeros(shape, dtype):
            return torch.zeros((B, K) + shape, dtype=dtype, device=dev)

        aux.update(tier_load=zeros((T,), torch.int32),
                   xfer_energy=zeros((T,), torch.float32),
                   in_transit=zeros((), torch.int32),
                   tier_ids=torch.tensor(self._tier_ids(M),
                                         device=dev).expand(B, M))
        return aux

    def on_event(self, stage, aux, st, trace, sysarr):
        if stage != "start":  # sample once per event, at end-of-event state
            return aux
        hot = _bucket_mask(aux, st.now, self.n_buckets)
        i32 = torch.int32
        B = st.now.shape[0]
        T = aux["tier_load"].shape[2]
        load = st.qlen + (st.run_task >= 0).to(torch.int64)
        tier_load = torch.zeros((B, T), dtype=torch.int64,
                                device=hot.device).scatter_add(
            1, aux["tier_ids"], load)
        if st.ready is None:
            e_xfer = torch.zeros((B, T), dtype=torch.float32,
                                 device=hot.device)
            in_transit = torch.zeros(B, dtype=i32, device=hot.device)
        else:
            e_xfer = st.e_xfer
            in_transit = ((st.status == PENDING)
                          & (st.ready > st.now[:, None])).sum(1).to(i32)
        values = {"tier_load": tier_load.to(i32), "xfer_energy": e_xfer,
                  "in_transit": in_transit}
        out = {**aux, "touched": aux["touched"] | hot}
        for k, v in values.items():
            out[k] = write_bucket(aux[k], hot, v)
        return out

    def finalize(self, aux, st):
        T = aux["tier_load"].shape[2]
        init = {"tier_load": torch.zeros((T,), dtype=torch.int32),
                "xfer_energy": torch.zeros((T,), dtype=torch.float32),
                "in_transit": torch.zeros((), dtype=torch.int32)}
        return _finalize_series(aux, {k: aux[k] for k in _SERIES}, init,
                                self.n_buckets)

    def to_json_dict(self) -> dict:
        return {"kind": "network", "n_buckets": self.n_buckets,
                "name": self.name}
