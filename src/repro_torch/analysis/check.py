"""The analyzer CLI: ``python -m repro_torch.analysis.check``
(counterpart of ``python -m repro.analysis.check``).

Exit status is the contract: 0 means every selected check ran and found
nothing; 1 means findings (printed one per line as ``path:line: RULE
[check] message``) or a crashed check. ``--json OUT`` writes the
structured report.

    python -m repro_torch.analysis.check                 # full suite
    python -m repro_torch.analysis.check --list-checks
    python -m repro_torch.analysis.check --layer 1       # AST only (no torch)
    python -m repro_torch.analysis.check --checks host-sync,float32
    python -m repro_torch.analysis.check --json analysis.json
    python -m repro_torch.analysis.check --device cpu    # Layer 2 on the CPU

Layer 2 walks its programs on the CUDA device unless ``--device cpu`` is
given; without a card and without it, its checks crash and the run
exits 1. ``chip_smoke.py``'s phase 8i runs the same checks on the card.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from repro_torch.analysis import (
    CHECKS,
    find_repo_root,
    format_findings,
    report_dict,
    run_checks,
)
from repro_torch.analysis.findings import write_json


def _parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.check",
        description="the port's discipline checker (AST lint + walker "
                    "audit)")
    ap.add_argument("--list-checks", action="store_true",
                    help="list registered checks and exit")
    ap.add_argument("--checks", default=None, metavar="NAME[,NAME...]",
                    help="run only these checks (default: all)")
    ap.add_argument("--layer", type=int, choices=(1, 2), default=None,
                    help="run only one layer (1=AST lint, 2=walker audit)")
    ap.add_argument("--json", default=None, metavar="OUT",
                    help="write the structured JSON report to OUT")
    ap.add_argument("--root", default=None,
                    help="repo root (default: walk up to pyproject.toml)")
    ap.add_argument("--device", default=None,
                    help="torch device of Layer 2's programs (default: "
                         "cuda; 'cpu' walks them on the CPU)")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = _parse_args(argv)
    if args.list_checks:
        for name in CHECKS.names():
            c = CHECKS.get(name)
            doc = (type(c).__doc__ or "").strip().splitlines()
            head = doc[0] if doc else ""
            print(f"{name:20s} {c.rule}  L{c.layer}  {head}")
        return 0

    selected = (args.checks.split(",") if args.checks
                else list(CHECKS.names()))
    layers = (args.layer,) if args.layer else (1, 2)
    findings, errors = run_checks(selected, root=args.root, layers=layers,
                                  device=args.device)
    ran = [n for n in selected if CHECKS.get(n).layer in layers]

    if findings:
        print(format_findings(findings))
    for err in errors:
        print(f"ERROR: check crashed: {err}", file=sys.stderr)

    root = args.root or find_repo_root()
    report = report_dict(findings, checks=ran, root=root, errors=errors)
    if args.json:
        write_json(args.json, report)
    n, e = len(findings), len(errors)
    status = "clean" if report["ok"] else (
        f"{n} finding(s)" + (f", {e} crashed check(s)" if e else ""))
    print(f"repro_torch.analysis: {len(ran)} check(s) -> {status}")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
