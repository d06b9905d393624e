"""Structured findings: what every check emits and what the CLI reports
(counterpart of ``repro/analysis/findings.py``, with the same fields,
ordering and JSON report).

A finding pins one violation to one location: ``file:line`` for the AST
layer and for an op the walker attributes to a line of the port, a
``walk:<program>`` pseudo-path for a whole-program finding of the walker
audit; plus the stable rule id (``TD00x`` AST rules, ``TX10x`` walker
rules) that tests key on.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable, List, Optional, Sequence


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One violation: rule id + location + message.

    ``path`` is repo-relative for file findings
    (``src/repro_torch/...``) and a ``walk:`` pseudo-path for
    whole-program findings; ``line`` is 1-based (0 = no line).
    """

    path: str
    line: int
    rule: str      # stable id, e.g. "TD003"
    check: str     # registered check name, e.g. "host-effects"
    message: str

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: {self.rule} [{self.check}] {self.message}"

    def to_json_dict(self) -> dict:
        return dataclasses.asdict(self)


def from_json_dict(d: dict) -> Finding:
    """Rebuild a finding from its :meth:`Finding.to_json_dict` form."""
    return Finding(path=d["path"], line=int(d["line"]), rule=d["rule"],
                   check=d["check"], message=d["message"])


def report_dict(findings: Sequence[Finding], *, checks: Sequence[str],
                root: str = ".",
                errors: Optional[Sequence[str]] = None) -> dict:
    """The ``--json`` report: findings + which checks ran + verdict.

    ``ok`` is the gate: true iff no findings *and* every requested check
    actually ran (``errors`` records checks that crashed; a crash is a
    failure, never a silent pass).
    """
    errors = list(errors or ())
    by_rule: dict = {}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    return {
        "root": str(root),
        "checks": list(checks),
        "errors": errors,
        "n_findings": len(findings),
        "findings_by_rule": dict(sorted(by_rule.items())),
        "findings": [f.to_json_dict() for f in sorted(findings)],
        "ok": not findings and not errors,
    }


def write_json(path, report: dict) -> None:
    with open(path, "w") as fh:
        json.dump(report, fh, indent=2, sort_keys=False)
        fh.write("\n")


def load_json(path) -> List[Finding]:
    """Findings back out of a ``--json`` report (round-trip helper)."""
    with open(path) as fh:
        report = json.load(fh)
    return [from_json_dict(d) for d in report["findings"]]


def format_findings(findings: Iterable[Finding]) -> str:
    return "\n".join(f.format() for f in sorted(findings))
