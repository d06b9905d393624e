"""Fleet builders (counterpart of ``repro/scenarios/fleets.py``): the two
paper systems, addressed by name. The CVB, range and federated fleets
are not ported."""
from __future__ import annotations

import dataclasses
from typing import ClassVar, List

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


_FLEETS = NameRegistry("fleet", case=str.lower)
_FLEETS.register("paper", PaperFleet())
_FLEETS.register("aws", AwsFleet())


def get_fleet(name: str):
    """Resolve a fleet builder by (case-insensitive) name."""
    return _FLEETS.get(name)


def is_registered_fleet(name: str) -> bool:
    return _FLEETS.is_registered(name)


def list_fleets() -> List[str]:
    return _FLEETS.names()
