"""Analyzer configuration: scan roots, excludes, escape hatches
(counterpart of ``repro/analysis/config.py``).

The port keeps its excludes here (:data:`EXCLUDE`), not in
``pyproject.toml``: ``[tool.repro.analysis]`` there belongs to the
reference's check.

Escape hatches are source annotations, one per line::

    # repro: allow-<name>[reason]      suppress rule <name> on this line
    # repro: jit-body                  opt a function INTO the stage rules

An annotation covers its own line and the line below it. ``<name>`` is
the marker of a rule (``host``, ``sync``, ``f64``, ...; the catalog in
:mod:`repro_torch.analysis` lists them); the bracketed reason is
mandatory: an unexplained suppression is itself a finding.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import glob
import os
import re
from typing import Dict, List, Optional, Tuple

#: Repo-relative glob patterns no check reads. The reference excludes
#: its frozen regression snapshots (``tests/_legacy_*.py``), which lie
#: outside every scope of the port's rules; the port has no such file.
EXCLUDE: Tuple[str, ...] = ()

_ALLOW_RE = re.compile(
    r"#\s*repro:\s*allow-(?P<name>[a-z0-9-]+)\s*"
    r"(?:\[(?P<reason>[^\]]*)\])?")
_JIT_BODY_RE = re.compile(r"#\s*repro:\s*jit-body\b")


def find_repo_root(start: Optional[str] = None) -> str:
    """Walk up from ``start`` (default: this file) to the pyproject dir."""
    d = os.path.abspath(start or os.path.dirname(__file__))
    while True:
        if os.path.exists(os.path.join(d, "pyproject.toml")):
            return d
        parent = os.path.dirname(d)
        if parent == d:  # filesystem root: fall back to cwd
            return os.getcwd()
        d = parent


@dataclasses.dataclass(frozen=True)
class AnalysisConfig:
    """Resolved config a check receives: where to look, what to skip,
    and where Layer 2 runs its programs (``device``: ``None`` is the CUDA
    device, an error without one, as at every entry point of the port;
    ``"cpu"`` when the caller asks for it)."""

    root: str                       # repo root (dir holding pyproject)
    exclude: Tuple[str, ...] = ()   # glob patterns, repo-relative
    device: Optional[str] = None    # Layer 2's torch device

    def is_excluded(self, path: str) -> bool:
        rel = self.relpath(path).replace(os.sep, "/")
        return any(
            fnmatch.fnmatch(rel, pat) or fnmatch.fnmatch(
                os.path.basename(rel), pat)
            for pat in self.exclude)

    def relpath(self, path: str) -> str:
        ap = os.path.abspath(path)
        try:
            return os.path.relpath(ap, self.root)
        except ValueError:
            return ap

    def python_files(self, *rels: str) -> List[str]:
        """Non-excluded ``.py`` files under repo-relative directories,
        files or glob patterns (``examples/torch_*.py``)."""
        out: List[str] = []
        for rel in rels:
            base = os.path.join(self.root, rel)
            if glob.has_magic(rel):
                paths = sorted(glob.glob(base))
            elif os.path.isfile(base):
                paths = [base]
            else:
                paths = []
                for dirpath, dirnames, filenames in os.walk(base):
                    dirnames.sort()
                    paths += [os.path.join(dirpath, fn)
                              for fn in sorted(filenames)]
            out += [p for p in paths
                    if p.endswith(".py") and not self.is_excluded(p)]
        return out


def load_config(root: Optional[str] = None,
                device: Optional[str] = None) -> AnalysisConfig:
    root = root or find_repo_root()
    return AnalysisConfig(root=os.path.abspath(root), exclude=EXCLUDE,
                          device=device)


def line_markers(source: str) -> Tuple[Dict[int, Dict[str, str]], List[int]]:
    """Scan source for escape-hatch annotations.

    Returns ``(allows, jit_body_lines)`` where ``allows`` maps 1-based
    line number → {rule-name: reason}; an ``allow`` with an empty or
    missing ``[reason]`` maps to the empty string (flagged separately as
    an unexplained suppression).
    """
    allows: Dict[int, Dict[str, str]] = {}
    jit_body: List[int] = []
    for i, line in enumerate(source.splitlines(), start=1):
        if "repro:" not in line:
            continue
        for m in _ALLOW_RE.finditer(line):
            allows.setdefault(i, {})[m.group("name")] = (
                m.group("reason") or "").strip()
        if _JIT_BODY_RE.search(line):
            jit_body.append(i)
    return allows, jit_body


def allowed(allows: Dict[int, Dict[str, str]], lineno: int,
            marker: str) -> Optional[Tuple[int, str]]:
    """The ``(line, reason)`` of the ``allow-<marker>`` annotation that
    covers ``lineno`` (on that line or the one above), else ``None``."""
    for ln in (lineno, lineno - 1):
        got = allows.get(ln, {})
        if marker in got:
            return ln, got[marker]
    return None
