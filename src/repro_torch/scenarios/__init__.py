"""Workload scenarios (counterpart of ``repro/scenarios``).

    Scenario = ArrivalProcess x TypeMix x DeadlineModel x RuntimeModel
               [x FleetBuilder]

The reference's ten built-in scenarios are registered under its names
and compositions: the paper's ``poisson`` workload, the stress axes
(``bursty``, ``diurnal``, ``flash-crowd``, ``heavy-tail``, ``drift``,
``tight-deadlines``, ``bursty-heavy-tail``), and two that bring their own
fleet (``wide-fleet`` on an 8x6 CVB fleet, ``federated-skew`` on
``paper_x2`` under a skewed type mix). Its eleven fleets are registered
too: the paper and AWS systems, the CVB and range generators, the
``paper_x*`` federations, ``mixed_sites`` and the tiered fleets. Both
registries are mutable and case-insensitive, and feed ``SweepSpec``,
``run_sweep``, ``trace_stack`` and the sweep CLI (``--scenario``,
``--list-scenarios``, ``--system``).
"""
from __future__ import annotations

from repro_torch.scenarios.arrivals import (
    DiurnalArrivals,
    FlashCrowdArrivals,
    MMPPArrivals,
    PoissonArrivals,
)
from repro_torch.scenarios.base import (
    ArrivalProcess,
    DeadlineModel,
    RuntimeModel,
    Scenario,
    TypeMix,
    component,
    component_from_json,
    component_to_json,
    replace,
)
from repro_torch.scenarios.deadlines import PaperDeadlines, ScaledDeadlines
from repro_torch.scenarios.fleets import (
    AwsFleet,
    CvbFleet,
    FederatedFleet,
    FleetBuilder,
    MixedSitesFleet,
    PaperFleet,
    RangeFleet,
    TieredFleet,
    get_fleet,
    is_registered_fleet,
    list_fleets,
    register_fleet,
    unregister_fleet,
)
from repro_torch.scenarios.mixes import (
    DriftMix,
    UniformMix,
    WeightedMix,
    mix_from_probs,
)
from repro_torch.scenarios.registry import (
    get,
    is_registered,
    list_scenarios,
    register,
    unregister,
)
from repro_torch.scenarios.runtimes import GammaRuntimes, LognormalRuntimes

__all__ = [
    "ArrivalProcess",
    "AwsFleet",
    "CvbFleet",
    "DEFAULT",
    "DeadlineModel",
    "DiurnalArrivals",
    "DriftMix",
    "FederatedFleet",
    "FlashCrowdArrivals",
    "FleetBuilder",
    "MixedSitesFleet",
    "GammaRuntimes",
    "LognormalRuntimes",
    "MMPPArrivals",
    "PaperDeadlines",
    "PaperFleet",
    "PoissonArrivals",
    "RangeFleet",
    "RuntimeModel",
    "ScaledDeadlines",
    "Scenario",
    "TypeMix",
    "UniformMix",
    "WeightedMix",
    "component",
    "component_from_json",
    "component_to_json",
    "default_scenario",
    "get",
    "get_fleet",
    "is_registered",
    "is_registered_fleet",
    "list_fleets",
    "list_scenarios",
    "mix_from_probs",
    "register",
    "register_fleet",
    "replace",
    "unregister",
    "unregister_fleet",
]

#: The paper's workload.
DEFAULT = Scenario(PoissonArrivals(), UniformMix(), PaperDeadlines(),
                   GammaRuntimes())

# A 4-type drift (vision-heavy -> speech-heavy) for the paper-sized fleets.
_DRIFT_4 = DriftMix(start=(0.4, 0.3, 0.2, 0.1), end=(0.1, 0.2, 0.3, 0.4))

for _name, _scn in [
    ("poisson", DEFAULT),
    ("bursty", Scenario(MMPPArrivals(), UniformMix(), PaperDeadlines(),
                        GammaRuntimes())),
    ("diurnal", Scenario(DiurnalArrivals(), UniformMix(), PaperDeadlines(),
                         GammaRuntimes())),
    ("flash-crowd", Scenario(FlashCrowdArrivals(), UniformMix(),
                             PaperDeadlines(), GammaRuntimes())),
    ("heavy-tail", Scenario(PoissonArrivals(), UniformMix(),
                            PaperDeadlines(), LognormalRuntimes())),
    ("drift", Scenario(PoissonArrivals(), _DRIFT_4, PaperDeadlines(),
                       GammaRuntimes())),
    ("tight-deadlines", Scenario(PoissonArrivals(), UniformMix(),
                                 ScaledDeadlines(0.75), GammaRuntimes())),
    ("bursty-heavy-tail", Scenario(MMPPArrivals(), UniformMix(),
                                   PaperDeadlines(), LognormalRuntimes())),
    ("wide-fleet", Scenario(PoissonArrivals(), UniformMix(),
                            PaperDeadlines(), GammaRuntimes(),
                            fleet=CvbFleet(n_task_types=8, n_machines=6))),
    # Federation stress: the 2-site paper replica under a skewed type mix.
    # With the type-affine sticky dispatcher (dispatch.Sticky(by_type=True))
    # the skew becomes per-site arrival skew: one site drowning while the
    # other idles, the regime fair_spill and least_queued target.
    ("federated-skew", Scenario(PoissonArrivals(),
                                WeightedMix((0.55, 0.25, 0.12, 0.08)),
                                PaperDeadlines(), GammaRuntimes(),
                                fleet=FederatedFleet(base="paper",
                                                     n_sites=2))),
]:
    register(_name, _scn)
del _name, _scn


def default_scenario() -> Scenario:
    """The paper's Poisson workload: what ``scenario="poisson"`` resolves
    to, and what ``poisson_trace`` and ``trace_stack`` default to."""
    return DEFAULT
