"""The port's discipline checker: an AST lint and a walker audit
(counterpart of ``repro/analysis``).

The invariants the port holds by hand (no JAX, float32 decisions, common
random numbers, frozen registry objects, an event loop that reads
nothing back between its periodic checks) machine-checked as a registry
of named checks behind one CLI::

    python -m repro_torch.analysis.check [--list-checks] [--checks A,B]
        [--layer 1|2] [--json OUT] [--root DIR] [--device DEV]

Exit status 0 means every selected check ran and found nothing; 1 means
findings or a crashed check.

Layer 1 (:mod:`~repro_torch.analysis.astlint`, TD001-TD006) is pure
``ast`` and runs with ``torch``, ``jax`` and ``repro`` unimportable.
Layer 2 (:mod:`~repro_torch.analysis.walk_audit`, TX101-TX103) runs the
reference's five engine programs (:mod:`~repro_torch.analysis.programs`)
under the roofline's walker, on the CUDA device unless the caller asks
for the CPU (``--device cpu``, ``run_checks(device="cpu")``; without a
card and without that, each Layer-2 check crashes and fails the gate);
``chip_smoke.py``'s phase 8i runs it on the card. It imports torch
inside ``run()``.

The catalog, each port rule beside the reference rule it stands for
(marker name in brackets):

=========================  =============================================
Port rule                  Reference
=========================  =============================================
TD001 registry-frozen      JD001 registry-frozen [registry]
TD002 rng-discipline       JD002 crn-discipline [rng]: numpy and torch
                           seeding and draws, not PRNG keys
TD003 host-effects         JD003 host-effects [host]; ``jax.debug``
                           has no port counterpart
TD004 host-sync            JD004 traced-branch [sync]: in eager PyTorch
                           a branch on a tensor is a host read, as are
                           ``.item()``, ``.tolist()``, ``.numpy()``,
                           ``.cpu()``
TD005 float32              JD005 oracle-f32 [f64]: the port has no
                           oracle (its tests use the reference's), so
                           the rule holds ``core/`` itself
TD006 no-reference-import  Layer 1's own contract of running without
                           JAX [import], over the whole port
TX101 walk-flatness        JX101 jaxpr-flatness: op multisets per full
                           iteration instead of jaxpr equations
TX102 walk-dtype           JX102 jaxpr-dtype [f64]: float64 and complex
                           outputs; PyTorch has no weak types, so the
                           weak-type half has no counterpart
TX103 walk-host-sync       JX103 jaxpr-effects [sync]: host reads in the
                           loop instead of callback primitives, and the
                           kernel launches of every iteration alike
(none)                     JX104 retrace-audit: an eager port traces
                           nothing, so there is nothing to retrace
=========================  =============================================

Markers: ``# repro: allow-<name>[reason]`` on a line or the line above
it; ``# repro: jit-body`` opts a function into the stage rules.
"""
from repro_torch.analysis import astlint, walk_audit  # noqa: F401  (register)
from repro_torch.analysis.config import (
    AnalysisConfig,
    find_repo_root,
    load_config,
)
from repro_torch.analysis.findings import Finding, format_findings, report_dict
from repro_torch.analysis.registry import (
    CHECKS,
    get,
    is_registered,
    names,
    register,
)

__all__ = [
    "AnalysisConfig",
    "CHECKS",
    "Finding",
    "find_repo_root",
    "format_findings",
    "get",
    "is_registered",
    "load_config",
    "names",
    "register",
    "report_dict",
    "run_checks",
]


def run_checks(check_names=None, *, root=None, layers=(1, 2), device=None):
    """Run checks by name (default: all registered) against ``root``,
    Layer 2 on ``device`` (``None``: the CUDA device).

    Returns ``(findings, errors)``; ``errors`` are ``"name: exc"``
    strings for checks that crashed (a crash must fail the gate, not
    silently pass it).
    """
    cfg = load_config(root, device)
    selected = [get(n) for n in (check_names or names())]
    findings, errors = [], []
    for check in selected:
        if check.layer not in layers:
            continue
        try:
            findings.extend(check.run(cfg))
        except Exception as exc:  # noqa: BLE001 — gate must see the crash
            errors.append(f"{check.name}: {type(exc).__name__}: {exc}")
    return findings, errors
