"""The check registry: named, frozen check objects behind a NameRegistry
(counterpart of ``repro/analysis/registry.py``).

Checks are frozen dataclasses registered under case-insensitive names,
so ``--checks host-effects,rng-discipline`` resolves the way ``--policy
FELARE`` does, and the analyzer can enumerate itself for
``--list-checks``.

The registry class is ``repro_torch.core.registry.NameRegistry``. Layer 1
must run on an interpreter without torch, so the file is side-loaded by
path when ``repro_torch.core.registry`` is not loaded yet: it imports
nothing beyond ``typing``, and whatever ``repro_torch.core``'s
``__init__`` comes to import stays out of Layer 1.
"""
from __future__ import annotations

import importlib.util
import os
import sys
from typing import Callable, List, Protocol, runtime_checkable

from repro_torch.analysis.findings import Finding


def _load_name_registry():
    mod = sys.modules.get("repro_torch.core.registry")
    if mod is None:
        here = os.path.dirname(os.path.abspath(__file__))
        path = os.path.join(os.path.dirname(here), "core", "registry.py")
        spec = importlib.util.spec_from_file_location(
            "repro_torch._analysis_core_registry", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod.NameRegistry


NameRegistry = _load_name_registry()


@runtime_checkable
class Check(Protocol):
    """One named analysis: scans the tree (or walked programs) for one rule.

    ``rule`` is the stable finding id (``TD00x`` / ``TX10x``); ``layer``
    is 1 (AST, no torch) or 2 (walker audit, needs torch). ``run(cfg)``
    returns findings; empty means clean.
    """

    name: str
    rule: str
    layer: int

    def run(self, cfg) -> List[Finding]: ...


def _check_check(name, item) -> None:
    for attr in ("name", "rule", "layer", "run"):
        if not hasattr(item, attr):
            raise TypeError(f"check {name!r} lacks .{attr}: {item!r}")
    if item.layer not in (1, 2):
        raise TypeError(f"check {name!r}: layer must be 1 or 2")


CHECKS: "NameRegistry" = NameRegistry(
    "analysis check", case=str.lower, check=_check_check)

register: Callable = CHECKS.register
get: Callable = CHECKS.get
names: Callable = CHECKS.names
is_registered: Callable = CHECKS.is_registered
