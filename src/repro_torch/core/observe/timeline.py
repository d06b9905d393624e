"""Time-resolved telemetry observers, ``timeline`` and
``fairness_trajectory`` (counterpart of
``repro/core/observe/timeline.py``).

Both sample the engine state into K uniform time buckets over each
replicate's horizon (its max deadline: no event can fire later).
Buckets with no event are forward-filled from the last observed value
in ``finalize``. A bucket write is a selection (``where`` over a one-hot
bucket mask), and every float sum is an explicit left-to-right one, so
the series round alike on the CPU and the card.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import equations, fairness
from repro_torch.core.observe.base import (
    Observer,
    bucket_edges,
    bucket_index,
    bucket_width,
    forward_fill,
    write_bucket,
)


def _bucket_mask(aux: dict, now: torch.Tensor, n_buckets: int):
    """(B, K) one-hot mask of each replicate's event bucket."""
    b = bucket_index(now, aux["width"], n_buckets)
    k = torch.arange(n_buckets, device=now.device)
    return k == b[:, None]


def _series_init(trace, n_buckets: int) -> dict:
    """The horizon, the bucket width and the touched mask."""
    horizon = trace.deadline.amax(1)
    B = horizon.shape[0]
    return {"horizon": horizon, "width": bucket_width(horizon, n_buckets),
            "touched": torch.zeros((B, n_buckets), dtype=torch.bool,
                                   device=horizon.device)}


def _site_table(site_of_machine: tuple, B: int, device) -> dict:
    """(B, F, W) machine indices of each site, padded to the widest
    site, and the mask of real entries (one table, expanded over B).
    Sites are contiguous blocks (validated by ``SystemSpec``), so each
    row is in machine order."""
    F = max(site_of_machine) + 1
    members = [[m for m, s in enumerate(site_of_machine) if s == f]
               for f in range(F)]
    W = max(len(r) for r in members)
    idx = [r + [0] * (W - len(r)) for r in members]
    valid = [[True] * len(r) + [False] * (W - len(r)) for r in members]
    return {"site_idx": torch.tensor(idx, device=device).expand(B, F, W),
            "site_valid": torch.tensor(valid, device=device).expand(B, F, W)}


def _finalize_series(aux: dict, series: dict, init: dict,
                     n_buckets: int) -> dict:
    filled = forward_fill(aux["touched"], series, init)
    filled["t"] = bucket_edges(aux["horizon"], n_buckets)
    filled["horizon"] = aux["horizon"]
    return filled


@dataclasses.dataclass(frozen=True)
class Timeline(Observer):
    """K-bucket queue-occupancy / energy / per-type completion series.

    Result tree (leaves lead with B, then the K=``n_buckets`` axis):
      ``t``         (B, K)    right edge of each bucket (seconds)
      ``qlen``      (B, K)    total queued tasks at the last event <= t
      ``running``   (B, K)    busy machines at the last event <= t
      ``e_dyn``     (B, K)    cumulative dynamic energy
      ``e_idle``    (B, K)    cumulative idle energy (estimate at event time)
      ``completed`` (B, K, S) cumulative on-time completions per type
      ``arrived``   (B, K, S) cumulative arrivals per type
      ``horizon``   (B,)      the sampled time horizon (max deadline)

    With ``per_site=True`` the tree also carries per-site series over the
    F sites of the partition the engine binds (one site on a flat
    system):
      ``site_qlen``  (B, K, F) queued tasks per site
      ``site_e_dyn`` (B, K, F) cumulative dynamic energy per site
                     (machines' dynamic power × accumulated busy time)
    """

    n_buckets: int = 64
    name: str = "timeline"
    per_site: bool = False
    site_of_machine: tuple | None = None  # engine-bound, not serialized

    def with_engine_config(self, *, site_of_machine=None, **config):
        if not self.per_site or site_of_machine is None:
            return self
        return dataclasses.replace(
            self, site_of_machine=tuple(int(s) for s in site_of_machine))

    def init(self, trace, sysarr):
        K, (S, M) = self.n_buckets, sysarr.eet.shape
        aux = _series_init(trace, K)
        B, dev = aux["horizon"].shape[0], trace.arrival.device

        def zeros(shape, dtype):
            return torch.zeros((B, K) + shape, dtype=dtype, device=dev)

        f32, i32 = torch.float32, torch.int32
        aux.update(qlen=zeros((), i32), running=zeros((), i32),
                   e_dyn=zeros((), f32), e_idle=zeros((), f32),
                   completed=zeros((S,), i32), arrived=zeros((S,), i32))
        if self.per_site:
            sites = self.site_of_machine or (0,) * M
            F = max(sites) + 1
            aux.update(_site_table(sites, B, dev))
            aux.update(site_qlen=zeros((F,), i32),
                       site_e_dyn=zeros((F,), f32))
        return aux

    def on_event(self, stage, aux, st, trace, sysarr):
        if stage != "start":  # sample once per event, at end-of-event state
            return aux
        hot = _bucket_mask(aux, st.now, self.n_buckets)
        i32 = torch.int32
        idle = st.now[:, None] - st.busy_time
        values = {
            "qlen": st.qlen.sum(1).to(i32),
            "running": (st.run_task >= 0).sum(1).to(i32),
            "e_dyn": st.e_dyn,
            "e_idle": equations.seq_dot(sysarr.p_idle, idle),
            "completed": st.completed.to(i32),
            "arrived": st.arrived.to(i32),
        }
        if self.per_site:
            idx, valid = aux["site_idx"][0], aux["site_valid"]
            values["site_qlen"] = torch.where(
                valid, st.qlen[:, idx], 0).sum(2).to(i32)
            # the reference's segment_sum adds each site's machines in
            # order onto 0; padding adds exact zeros
            e_site = torch.where(valid, (sysarr.p_dyn * st.busy_time)[:, idx],
                                 0.0)
            values["site_e_dyn"] = equations.seq_sum(e_site)
        out = {**aux, "touched": aux["touched"] | hot}
        for k, v in values.items():
            out[k] = write_bucket(aux[k], hot, v)
        return out

    def finalize(self, aux, st):
        keys = ("qlen", "running", "e_dyn", "e_idle", "completed", "arrived")
        if self.per_site:
            keys += ("site_qlen", "site_e_dyn")
        series = {k: aux[k] for k in keys}
        init = {k: torch.zeros((), dtype=v.dtype) for k, v in series.items()}
        return _finalize_series(aux, series, init, self.n_buckets)

    def to_json_dict(self) -> dict:
        return {"kind": "timeline", "n_buckets": self.n_buckets,
                "name": self.name, "per_site": self.per_site}


@dataclasses.dataclass(frozen=True)
class FairnessTrajectory(Observer):
    """Suffered-type indicator (Alg. 4) over K time buckets.

    Samples the mask the FELARE wrapper consults at each mapping event.
    With the default ``fairness_factor=None`` the engine binds its own
    configured factor (:meth:`with_engine_config`); set it explicitly only
    to observe a counterfactual fairness limit.

    Result: ``suffered`` (B, K, S) bool, ``cr`` (B, K, S) per-type
    completion rate, ``t`` (B, K) bucket edges, ``horizon`` (B,).
    """

    n_buckets: int = 64
    fairness_factor: float | None = None
    name: str = "fairness_trajectory"

    def with_engine_config(self, *, fairness_factor=1.0, **config):
        if self.fairness_factor is not None:
            return self
        return dataclasses.replace(self, fairness_factor=fairness_factor)

    def init(self, trace, sysarr):
        K, S = self.n_buckets, sysarr.eet.shape[0]
        aux = _series_init(trace, K)
        B, dev = aux["horizon"].shape[0], trace.arrival.device
        aux["suffered"] = torch.zeros((B, K, S), dtype=torch.bool,
                                      device=dev)
        aux["cr"] = torch.ones((B, K, S), dtype=torch.float32, device=dev)
        return aux

    def on_event(self, stage, aux, st, trace, sysarr):
        if stage != "map":  # sample the mask the mapper just consulted
            return aux
        hot = _bucket_mask(aux, st.now, self.n_buckets)
        suffered = fairness.suffered_types(st.completed, st.arrived,
                                           self.fairness_factor)
        cr = fairness.completion_rates(st.completed, st.arrived)
        return {**aux, "touched": aux["touched"] | hot,
                "suffered": write_bucket(aux["suffered"], hot, suffered),
                "cr": write_bucket(aux["cr"], hot, cr)}

    def finalize(self, aux, st):
        series = {"suffered": aux["suffered"], "cr": aux["cr"]}
        init = {"suffered": torch.zeros((), dtype=torch.bool),
                "cr": torch.ones((), dtype=torch.float32)}
        return _finalize_series(aux, series, init, self.n_buckets)

    def to_json_dict(self) -> dict:
        return {"kind": "fairness_trajectory", "n_buckets": self.n_buckets,
                "fairness_factor": self.fairness_factor, "name": self.name}
