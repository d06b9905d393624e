"""Fleet builders (counterpart of ``repro/scenarios/fleets.py``): the two
paper systems and their federations, addressed by name. The CVB, range
and ``mixed_sites`` fleets are not ported."""
from __future__ import annotations

import dataclasses
from typing import ClassVar, List

import numpy as np

from repro_torch.core.registry import NameRegistry
from repro_torch.core.types import SystemSpec


@dataclasses.dataclass(frozen=True)
class PaperFleet:
    """The Sec. VI-A synthetic 4x4 system (Table I + power profile)."""

    kind: ClassVar[str] = "paper"
    queue_size: int = 2
    fairness_factor: float = 1.0

    def build(self) -> SystemSpec:
        from repro_torch.core import api

        return api.paper_system(self.queue_size, self.fairness_factor)


@dataclasses.dataclass(frozen=True)
class AwsFleet:
    """The AWS 2x2 scenario: t2.xlarge/g3s.xlarge x FaceNet/DeepSpeech."""

    kind: ClassVar[str] = "aws"
    queue_size: int = 2
    fairness_factor: float = 1.0

    def build(self) -> SystemSpec:
        from repro_torch.core import api

        return api.aws_system(self.queue_size, self.fairness_factor)


@dataclasses.dataclass(frozen=True)
class FederatedFleet:
    """F replicas of a registered base fleet, one per site.

    The base system's machines are tiled F times and ``site_of_machine``
    partitions the copies into equal contiguous blocks. Every replica
    shares the base EET and power profile, so dispatch quality, not
    machine heterogeneity, is the isolated variable.
    """

    kind: ClassVar[str] = "federated"
    base: str = "paper"
    n_sites: int = 2

    def __post_init__(self):
        if self.n_sites < 1:
            raise ValueError("federation must have >= 1 site")

    def build(self) -> SystemSpec:
        spec = get_fleet(self.base).build()
        F, M = self.n_sites, spec.n_machines
        return SystemSpec(
            eet=np.tile(np.asarray(spec.eet), (1, F)),
            p_dyn=np.tile(np.asarray(spec.p_dyn), F),
            p_idle=np.tile(np.asarray(spec.p_idle), F),
            queue_size=spec.queue_size,
            fairness_factor=spec.fairness_factor,
            site_of_machine=tuple(s for s in range(F) for _ in range(M)),
        )


@dataclasses.dataclass(frozen=True)
class TieredFleet:
    """Edge-cloud hierarchy: device sites plus one cloud site.

    ``n_device_sites`` replicas of the base fleet sit on the device tier
    (tier 0) next to a single cloud site (tier 2) holding
    ``cloud_replicas`` copies of the base machines, each
    ``cloud_speedup`` times faster (EET divided) and mains-powered
    (``p_idle = 0``). The sites are unequal, so the engine folds them
    with masked views. The tiers matter once a network is attached: tasks
    originate on the device sites and pay their link to the cloud.
    """

    kind: ClassVar[str] = "tiered"
    base: str = "paper"
    n_device_sites: int = 3
    cloud_replicas: int = 2
    cloud_speedup: float = 2.0

    def __post_init__(self):
        if self.n_device_sites < 1:
            raise ValueError("tiered fleet needs >= 1 device site")
        if self.cloud_replicas < 1:
            raise ValueError("tiered fleet needs >= 1 cloud replica")
        if float(self.cloud_speedup) <= 0.0:
            raise ValueError("cloud_speedup must be > 0")

    def build(self) -> SystemSpec:
        spec = get_fleet(self.base).build()
        D, C, M = self.n_device_sites, self.cloud_replicas, spec.n_machines
        eet = np.asarray(spec.eet, np.float32)
        cloud_eet = (np.tile(eet, (1, C))
                     / np.float32(self.cloud_speedup)).astype(np.float32)
        sites = [s for s in range(D) for _ in range(M)] + [D] * (C * M)
        return SystemSpec(
            eet=np.concatenate([np.tile(eet, (1, D)), cloud_eet], axis=1),
            p_dyn=np.concatenate([np.tile(np.asarray(spec.p_dyn), D),
                                  np.tile(np.asarray(spec.p_dyn), C)]),
            p_idle=np.concatenate([np.tile(np.asarray(spec.p_idle), D),
                                   np.zeros((C * M,), np.float32)]),
            queue_size=spec.queue_size,
            fairness_factor=spec.fairness_factor,
            site_of_machine=tuple(sites),
            tier_of_site=(0,) * D + (2,),
        )


_FLEETS = NameRegistry("fleet", case=str.lower)
for _name, _fleet in [
    ("paper", PaperFleet()),
    ("aws", AwsFleet()),
    ("paper_x2", FederatedFleet(base="paper", n_sites=2)),
    ("paper_x4", FederatedFleet(base="paper", n_sites=4)),
    ("paper_x8", FederatedFleet(base="paper", n_sites=8)),
    ("paper_x32", FederatedFleet(base="paper", n_sites=32)),
    ("tiered_x4", TieredFleet(n_device_sites=3)),
    ("tiered_x16", TieredFleet(n_device_sites=15)),
]:
    _FLEETS.register(_name, _fleet)
del _name, _fleet


def get_fleet(name: str):
    """Resolve a fleet builder by (case-insensitive) name."""
    return _FLEETS.get(name)


def is_registered_fleet(name: str) -> bool:
    return _FLEETS.is_registered(name)


def list_fleets() -> List[str]:
    return _FLEETS.names()
