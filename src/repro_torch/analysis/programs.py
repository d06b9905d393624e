"""The engine programs the walker audit runs (counterpart of
``repro/analysis/programs.py``).

One builder, parameterized the way the engine is: fleet x heuristic x
dispatcher x observers x dynamics x network, on the kernels or the plain
path. It returns ``(fn, args)``, the simulator of
:func:`repro_torch.core.engine.make_simulator` and a batch of traces
synthesized from a seed, as the sweep runner builds them.

torch is imported inside the builder: importing
:mod:`repro_torch.analysis` (and running Layer 1) needs no torch.
"""
from __future__ import annotations

from typing import Sequence, Tuple

#: The default audit matrix, the reference's five programs: the paper
#: pair on the heaviest built-ins, once bare and once with the observers
#: and a machine dynamics, the tiered fleet with the network, and FELARE
#: on the kernels (``fused``: the map decision on ``map_decide`` and
#: ``evict_stats``, the dispatcher's walk on ``balance_scan``; the
#: counterpart of the reference's ``+pallas``).
DEFAULT_PROGRAMS: Tuple[Tuple[str, dict], ...] = (
    ("paper_x2/ELARE", dict(fleet="paper_x2", heuristic="ELARE")),
    ("paper_x2/FELARE", dict(fleet="paper_x2", heuristic="FELARE")),
    ("paper_x2/FELARE+aux", dict(
        fleet="paper_x2", heuristic="FELARE",
        observers=("timeline", "task_log", "health"),
        dynamics="bernoulli_updown")),
    ("tiered_x4/FELARE+net", dict(
        fleet="tiered_x4", heuristic="FELARE",
        dispatcher="tier_aware", network="tiered",
        observers=("network", "task_log"))),
    ("paper_x2/FELARE+fused", dict(
        fleet="paper_x2", heuristic="FELARE", fused=True)),
)


def simulator_program(fleet: str = "paper_x2", heuristic: str = "FELARE",
                      dispatcher: str = "fair_spill",
                      observers: Sequence[str] = (),
                      dynamics: str | None = None,
                      network: str | None = None,
                      fused: bool = False,
                      n_tasks: int = 24, seed: int = 0,
                      rates: Sequence[float] = (4.0,), reps: int = 1,
                      max_steps: int | None = None, device=None):
    """Build ``(simulate, (traces,))`` for one engine configuration.

    The batch holds ``len(rates) * reps`` Poisson traces of ``n_tasks``
    tasks (B = 1 by default) on ``device`` (``None``: the CUDA device,
    an error without one). ``fused=True`` routes the map
    decision and the dispatcher's balance walk through the kernels
    (:func:`repro_torch.core.policy.with_fused_map`,
    :func:`repro_torch.core.dispatch.with_fused_balance`), the toggle of
    ``SweepSpec.use_fused_map``.
    """
    from repro_torch import scenarios
    from repro_torch.core import dispatch, engine, policy
    from repro_torch.core.device import resolve_device

    device = resolve_device(device)
    spec = scenarios.get_fleet(fleet).build()
    pol = policy.get(heuristic)
    disp = dispatch.resolve(dispatcher)
    if fused:
        pol = policy.with_fused_map(pol)
        disp = dispatch.with_fused_balance(disp)
    sim = engine.make_simulator(
        pol, spec.as_torch(device), queue_size=spec.queue_size,
        fairness_factor=float(spec.fairness_factor), max_steps=max_steps,
        dispatcher=disp, site_of_machine=spec.site_of_machine,
        observers=tuple(observers), dynamics=dynamics, network=network,
        tier_of_site=spec.tier_of_site)
    grid = scenarios.DEFAULT.stack(seed, tuple(rates), reps, n_tasks,
                                   spec.eet, device=device)
    traces = type(grid)(*(x.reshape((-1,) + x.shape[2:]) for x in grid))
    return sim, (traces,)
