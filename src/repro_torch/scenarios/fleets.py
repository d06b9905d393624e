"""Fleet builders (counterpart of ``repro/scenarios/fleets.py``): which
heterogeneous edge system a scenario runs on, addressed by name.

A :class:`FleetBuilder` turns a few parameters into a
:class:`~repro_torch.core.types.SystemSpec`. The two paper systems, their
federations and the tiered fleets are built from fixed tables. The
synthetic generators (:class:`CvbFleet`, :class:`RangeFleet`,
:class:`MixedSitesFleet`) draw their EET and powers from ``seed``.

A registered name means the same machines in both packages: a study runs
on one sampled fleet, so another draw would shift every number, not just
the noise. The builders behind the registered synthetic fleets (``cvb``,
``range``, ``mixed_sites``, and ``wide-fleet``'s ``CvbFleet(8, 6)``,
which equals ``cvb``'s) therefore return the reference's drawn float32
tables, kept below (:data:`PINNED`); any other parameters are drawn with
numpy from ``seed`` and match the reference in distribution only.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, List, Protocol, Tuple

import numpy as np

from repro_torch.core import eet as eet_mod
from repro_torch.core.registry import NameRegistry
from repro_torch.core.types import SystemSpec
from repro_torch.scenarios.base import component, split_seed


class FleetBuilder(Protocol):
    """Builds the SystemSpec a scenario simulates."""

    kind: str

    def build(self) -> SystemSpec: ...


def _sample_powers(seed_dyn, seed_idle, n_machines: int, p_dyn_range,
                   p_idle_range):
    """Uniform per-machine dynamic and idle powers from the ranges."""
    p_dyn = np.random.default_rng(seed_dyn).uniform(
        p_dyn_range[0], p_dyn_range[1], n_machines).astype(np.float32)
    p_idle = np.random.default_rng(seed_idle).uniform(
        p_idle_range[0], p_idle_range[1], n_machines).astype(np.float32)
    return p_dyn, p_idle


def _floats(builder, *names) -> None:
    """Store the named range fields of a frozen builder as float tuples."""
    for name in names:
        object.__setattr__(builder, name,
                           tuple(float(x) for x in getattr(builder, name)))


@component("fleet")
@dataclasses.dataclass(frozen=True)
class PaperFleet:
    """The Sec. VI-A synthetic 4x4 system (Table I + power profile)."""

    kind: ClassVar[str] = "paper"
    queue_size: int = 2
    fairness_factor: float = 1.0

    def build(self) -> SystemSpec:
        from repro_torch.core import api

        return api.paper_system(self.queue_size, self.fairness_factor)


@component("fleet")
@dataclasses.dataclass(frozen=True)
class AwsFleet:
    """The AWS 2x2 scenario: t2.xlarge/g3s.xlarge x FaceNet/DeepSpeech."""

    kind: ClassVar[str] = "aws"
    queue_size: int = 2
    fairness_factor: float = 1.0

    def build(self) -> SystemSpec:
        from repro_torch.core import api

        return api.aws_system(self.queue_size, self.fairness_factor)


@component("fleet")
@dataclasses.dataclass(frozen=True)
class CvbFleet:
    """Coefficient-of-Variation-Based synthetic fleet of any size.

    The (S, M) EET comes from the CVB method the paper used to generate
    Table I (``eet.cvb_eet``): ``cv_task`` sets the task heterogeneity,
    ``cv_mach`` the machine heterogeneity. Dynamic and idle powers are
    uniform draws from the ranges. Deterministic in ``seed``.
    """

    kind: ClassVar[str] = "cvb"
    n_task_types: int = 8
    n_machines: int = 6
    seed: int = 0
    mean_task: float = 3.0
    cv_task: float = 0.6
    cv_mach: float = 0.6
    p_dyn_range: Tuple[float, float] = (1.0, 3.0)
    p_idle_range: Tuple[float, float] = (0.03, 0.08)
    queue_size: int = 2
    fairness_factor: float = 1.0

    def __post_init__(self):
        _floats(self, "p_dyn_range", "p_idle_range")
        if self.n_task_types < 1 or self.n_machines < 1:
            raise ValueError("fleet must have >= 1 task type and machine")

    def build(self) -> SystemSpec:
        if self in PINNED:
            return _pinned(self)
        s_eet, s_dyn, s_idle = split_seed(self.seed, 3)
        eet = eet_mod.cvb_eet(
            np.random.default_rng(s_eet), self.n_task_types, self.n_machines,
            mean_task=self.mean_task, cv_task=self.cv_task,
            cv_mach=self.cv_mach)
        p_dyn, p_idle = _sample_powers(s_dyn, s_idle, self.n_machines,
                                       self.p_dyn_range, self.p_idle_range)
        return SystemSpec(eet=eet, p_dyn=p_dyn, p_idle=p_idle,
                          queue_size=self.queue_size,
                          fairness_factor=self.fairness_factor)


@component("fleet")
@dataclasses.dataclass(frozen=True)
class RangeFleet:
    """Uniform-range synthetic fleet: EET entries i.i.d. in ``eet_range``.

    The flattest heterogeneity model (no task or machine structure), a
    null against :class:`CvbFleet`'s structured rows. Deterministic in
    ``seed``.
    """

    kind: ClassVar[str] = "range"
    n_task_types: int = 6
    n_machines: int = 6
    seed: int = 0
    eet_range: Tuple[float, float] = (0.5, 5.0)
    p_dyn_range: Tuple[float, float] = (1.0, 3.0)
    p_idle_range: Tuple[float, float] = (0.03, 0.08)
    queue_size: int = 2
    fairness_factor: float = 1.0

    def __post_init__(self):
        _floats(self, "eet_range", "p_dyn_range", "p_idle_range")
        for name in ("eet_range", "p_dyn_range", "p_idle_range"):
            lo, hi = getattr(self, name)
            if not 0 < lo <= hi:
                raise ValueError(f"{name} must satisfy 0 < lo <= hi, "
                                 f"got {(lo, hi)}")
        if self.n_task_types < 1 or self.n_machines < 1:
            raise ValueError("fleet must have >= 1 task type and machine")

    def build(self) -> SystemSpec:
        if self in PINNED:
            return _pinned(self)
        s_eet, s_dyn, s_idle = split_seed(self.seed, 3)
        eet = np.random.default_rng(s_eet).uniform(
            self.eet_range[0], self.eet_range[1],
            (self.n_task_types, self.n_machines)).astype(np.float32)
        p_dyn, p_idle = _sample_powers(s_dyn, s_idle, self.n_machines,
                                       self.p_dyn_range, self.p_idle_range)
        return SystemSpec(eet=eet, p_dyn=p_dyn, p_idle=p_idle,
                          queue_size=self.queue_size,
                          fairness_factor=self.fairness_factor)


# --------------------------------------------------------------------------
# Federation builders: multi-site systems for the dispatch layer
# --------------------------------------------------------------------------


@component("fleet")
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


@component("fleet")
@dataclasses.dataclass(frozen=True)
class MixedSitesFleet:
    """Heterogeneous federation: per-site CVB-generated machine groups.

    Site ``i`` gets ``site_machines[i]`` machines with machine
    heterogeneity ``cv_mach[i]``, all serving the same S task types: e.g.
    a big uniform site next to a small, highly heterogeneous one, where
    EET-aware dispatch (``min_eet``) separates from load-blind rules. The
    sites differ in size, so the engine folds them with masked views.
    Deterministic in ``seed``.
    """

    kind: ClassVar[str] = "mixed_sites"
    n_task_types: int = 4
    site_machines: Tuple[int, ...] = (4, 3)
    cv_mach: Tuple[float, ...] = (0.3, 0.9)
    seed: int = 0
    mean_task: float = 3.0
    cv_task: float = 0.6
    p_dyn_range: Tuple[float, float] = (1.0, 3.0)
    p_idle_range: Tuple[float, float] = (0.03, 0.08)
    queue_size: int = 2
    fairness_factor: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "site_machines",
                           tuple(int(m) for m in self.site_machines))
        _floats(self, "cv_mach", "p_dyn_range", "p_idle_range")
        if len(self.site_machines) != len(self.cv_mach):
            raise ValueError("site_machines and cv_mach must align per site")
        if not self.site_machines or min(self.site_machines) < 1:
            raise ValueError("every site needs >= 1 machine")

    @property
    def site_of_machine(self) -> Tuple[int, ...]:
        return tuple(s for s, m in enumerate(self.site_machines)
                     for _ in range(m))

    def build(self) -> SystemSpec:
        if self in PINNED:
            return _pinned(self)
        eet_cols, p_dyn_cols, p_idle_cols = [], [], []
        for seed, m, cv in zip(split_seed(self.seed, len(self.cv_mach)),
                               self.site_machines, self.cv_mach):
            s_eet, s_dyn, s_idle = split_seed(seed, 3)
            eet_cols.append(eet_mod.cvb_eet(
                np.random.default_rng(s_eet), self.n_task_types, m,
                mean_task=self.mean_task, cv_task=self.cv_task, cv_mach=cv))
            p_dyn, p_idle = _sample_powers(s_dyn, s_idle, m,
                                           self.p_dyn_range,
                                           self.p_idle_range)
            p_dyn_cols.append(p_dyn)
            p_idle_cols.append(p_idle)
        return SystemSpec(
            eet=np.concatenate(eet_cols, axis=1),
            p_dyn=np.concatenate(p_dyn_cols),
            p_idle=np.concatenate(p_idle_cols),
            queue_size=self.queue_size,
            fairness_factor=self.fairness_factor,
            site_of_machine=self.site_of_machine)


@component("fleet")
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


# --------------------------------------------------------------------------
# The reference's draws for the registered synthetic fleets: its
# ``build()`` of each instance below (JAX's threefry from seed 0), in
# float32, as (eet rows, p_dyn, p_idle).
# --------------------------------------------------------------------------

PINNED = {
    CvbFleet(): (
        ((1.3629665, 2.487142, 2.351111, 2.4122534, 5.317029, 3.035026),
         (1.4338026, 5.0198746, 1.7946844, 0.55385, 1.5139323, 0.9962487),
         (1.3326446, 0.5551361, 0.43607384, 0.29811668, 0.11808032,
          0.5526655),
         (2.261016, 2.8574326, 4.548711, 2.3668396, 0.5004709, 2.7954745),
         (5.817282, 7.473688, 2.475848, 5.3584642, 0.9943929, 0.9660697),
         (1.0579312, 0.6823982, 1.5849551, 2.3614345, 1.8620895,
          0.32866454),
         (5.228802, 5.207557, 6.6912217, 1.0063398, 3.033452, 7.2394195),
         (1.5762544, 1.3979331, 2.213107, 2.6967309, 1.7562656,
          1.8483133)),
        (1.0145876, 1.0417824, 2.162853, 1.723676, 1.4460754, 1.2385767),
        (0.07512247, 0.07561464, 0.04705238, 0.041004553, 0.062418833,
         0.055376757)),
    RangeFleet(): (
        ((4.2904134, 1.320704, 1.5223014, 1.0432653, 1.3631606, 3.7490675),
         (3.9445052, 1.186432, 4.782678, 0.6318971, 0.9441974, 2.9891448),
         (1.060012, 3.1755292, 4.8177085, 3.6195223, 3.7584317, 1.9317396),
         (4.1903214, 3.3846183, 1.6834404, 1.3640721, 3.9915075, 4.3523407),
         (4.181698, 1.9006093, 4.157879, 4.775249, 0.5267164, 3.518042),
         (4.844369, 1.0416651, 1.7511158, 4.928462, 4.0491, 2.397812)),
        (1.0145876, 1.0417824, 2.162853, 1.723676, 1.4460754, 1.2385767),
        (0.07512247, 0.07561464, 0.04705238, 0.041004553, 0.062418833,
         0.055376757)),
    MixedSitesFleet(): (
        ((6.322724, 8.043402, 5.4246964, 4.4341354, 2.5126896, 2.4083054,
          0.31529742),
         (0.6247777, 0.89051956, 0.76178354, 0.62563825, 0.05774474,
          0.030580992, 3.8494916),
         (7.399922, 3.7130268, 3.741004, 4.797271, 2.4323664, 0.94543046,
          0.1356404),
         (1.2184659, 1.3681046, 1.5791545, 1.3757592, 1.4877331, 2.13887,
          0.9516389)),
        (2.804899, 2.8245857, 1.6820953, 1.4401822, 1.45697, 2.4761865,
         1.0213306),
        (0.04334947, 0.0666975, 0.07768615, 0.04047708, 0.06165191,
         0.072468385, 0.048356775)),
}


def _pinned(builder) -> SystemSpec:
    """The SystemSpec of a builder equal to one of :data:`PINNED`'s."""
    eet, p_dyn, p_idle = (np.asarray(x, np.float32) for x in PINNED[builder])
    return SystemSpec(eet=eet, p_dyn=p_dyn, p_idle=p_idle,
                      queue_size=builder.queue_size,
                      fairness_factor=builder.fairness_factor,
                      site_of_machine=getattr(builder, "site_of_machine",
                                              None))


# --------------------------------------------------------------------------
# Fleet registry
# --------------------------------------------------------------------------


def _check(name, fleet) -> None:
    if not hasattr(fleet, "build"):
        raise TypeError(f"fleet {name!r} must have a .build() method")


_REGISTRY = NameRegistry("fleet", case=str.lower, check=_check)


def register_fleet(name: str, fleet: FleetBuilder, *,
                   overwrite: bool = False) -> FleetBuilder:
    """Register a fleet builder under ``name`` (case-insensitive)."""
    return _REGISTRY.register(name, fleet, overwrite=overwrite)


def unregister_fleet(name: str) -> None:
    """Remove a registered fleet builder (KeyError if absent)."""
    _REGISTRY.unregister(name)


def is_registered_fleet(name: str) -> bool:
    return _REGISTRY.is_registered(name)


def get_fleet(name: str) -> FleetBuilder:
    """Resolve a fleet builder by (case-insensitive) name."""
    return _REGISTRY.get(name)


def list_fleets() -> List[str]:
    """Sorted names of every registered fleet builder."""
    return _REGISTRY.names()


for _name, _fleet in [
    ("paper", PaperFleet()),
    ("aws", AwsFleet()),
    ("cvb", CvbFleet()),
    ("range", RangeFleet()),
    ("paper_x2", FederatedFleet(base="paper", n_sites=2)),
    ("paper_x4", FederatedFleet(base="paper", n_sites=4)),
    ("paper_x8", FederatedFleet(base="paper", n_sites=8)),
    ("paper_x32", FederatedFleet(base="paper", n_sites=32)),
    ("mixed_sites", MixedSitesFleet()),
    ("tiered_x4", TieredFleet(n_device_sites=3)),
    ("tiered_x16", TieredFleet(n_device_sites=15)),
]:
    register_fleet(_name, _fleet)
del _name, _fleet
