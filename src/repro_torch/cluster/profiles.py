"""Machine profiles for the serving cluster (counterpart of
``repro/cluster/profiles.py``), in numpy.

A *machine type* is a device group with (peak FLOP/s, HBM bandwidth,
dynamic power, idle power). The EET matrix, the paper's profiling input,
is derived from the roofline model per (architecture x machine): the
expected latency of one request is max(compute term, memory term) for
its token count.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class MachineProfile:
    name: str
    chips: int
    peak_flops: float     # per chip, bf16
    hbm_bw: float         # bytes/s per chip
    p_dyn: float          # watts per chip under load
    p_idle: float         # watts per chip idle

    @property
    def total_flops(self):
        return self.chips * self.peak_flops

    @property
    def total_bw(self):
        return self.chips * self.hbm_bw


# The reference's modelled heterogeneous serving fleet, copied number for
# number only so that both packages derive the same EET tables and power
# vectors from it. These are the reference's modelling inputs for its
# machine groups, not measurements of any device this port runs on.
FLEET = (
    MachineProfile("v5e-4", chips=4, peak_flops=197e12, hbm_bw=819e9,
                   p_dyn=170.0, p_idle=35.0),
    MachineProfile("v5e-1", chips=1, peak_flops=197e12, hbm_bw=819e9,
                   p_dyn=180.0, p_idle=38.0),
    MachineProfile("v4-lite", chips=2, peak_flops=110e12, hbm_bw=600e9,
                   p_dyn=140.0, p_idle=30.0),
    MachineProfile("cpu-host", chips=1, peak_flops=3e12, hbm_bw=150e9,
                   p_dyn=60.0, p_idle=10.0),
)


def request_cost(cfg, n_tokens: int, *, decode: bool = False):
    """(flops, hbm_bytes) of one request on an architecture."""
    n_active = cfg.active_params()
    flops = 2.0 * n_active * n_tokens
    if decode:
        byts = 2.0 * n_active * n_tokens      # weights re-streamed per token
    else:
        byts = 2.0 * n_active                 # one weight pass (batched)
    return flops, byts


def eet_from_roofline(cfgs, machines=FLEET, *, n_tokens=256, decode=False,
                      overhead_s=0.002):
    """EET[i, j] = roofline latency of arch i's request on machine j."""
    eet = np.zeros((len(cfgs), len(machines)), np.float32)
    for i, cfg in enumerate(cfgs):
        flops, byts = request_cost(cfg, n_tokens, decode=decode)
        for j, m in enumerate(machines):
            eet[i, j] = max(flops / m.total_flops,
                            byts / m.total_bw) + overhead_s
    return eet


def power_vectors(machines=FLEET):
    p_dyn = np.array([m.p_dyn * m.chips for m in machines], np.float32)
    p_idle = np.array([m.p_idle * m.chips for m in machines], np.float32)
    return p_dyn, p_idle
