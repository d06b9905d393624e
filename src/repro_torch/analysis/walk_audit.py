"""Layer 2: the walker audit, discipline rules checked on the ops the
event loop really runs (counterpart of ``repro/analysis/jaxpr_audit.py``).

Where Layer 1 reads source, Layer 2 runs the programs of
:mod:`repro_torch.analysis.programs` once each under the roofline's
:class:`~repro_torch.roofline.walk.Walker` and reads every op that
reaches the dispatcher. Ops are grouped by the loop's iteration, read
from ``engine.COUNTS["loop_iterations"]`` when the op is dispatched:
bucket 0 holds the set-up and the first iteration, the last bucket the
tail (the check that ends the loop and the metrics), and the *full
iterations* lie between. A kernel wrapper counts once per call, as
``kernel.<name>``, whichever route runs. Each flagged op is attributed
to the innermost frame of the repository outside ``roofline/`` and
``analysis/``, so its finding names ``file:line``, and the Layer-1
``allow`` marker on that line (or the one above) suppresses it. Three
rules:

  TX101 walk-flatness   the site count F is data, not program: each full
                        iteration's op multiset, kernel scopes included,
                        is the same across fleets in the three pairs of
                        JX101 (the paper pair, the tiered pair with the
                        network, the paper pair on the kernels).
  TX102 walk-dtype      no float64 or complex output in a full iteration
                        unless its line is marked ``allow-f64``. PyTorch
                        has no weak types, so JX102's second half has no
                        counterpart.
  TX103 walk-host-sync  no host read in a full iteration unless its line
                        is marked ``allow-sync``: an op whose result the
                        host reads (:data:`HOST_READ_OPS`: ``.item()``,
                        ``bool(t)``, data-dependent shapes) and, on the
                        card, any op taking a CUDA tensor to the CPU and
                        any call that PyTorch's sync debug mode reports (a
                        second run without the walker, which also sees
                        inside the kernel wrappers); and no full
                        iteration whose kernel scopes differ from the
                        first's.

JX104 (one trace per configuration) has no counterpart: the port runs
eagerly and traces nothing.

The checks walk their programs on ``AnalysisConfig.device``, and the
functions here on their ``device`` argument: ``None`` is the CUDA device,
as at every entry point of the port, and without a card it raises (a
crashed check) unless the caller asks for ``"cpu"``. ``chip_smoke.py``'s
phase 8i runs them on the card, the fused program on the CUDA kernels.
torch is imported inside the functions; without it a Layer-2 check
reports one finding instead of crashing.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import inspect
import os
import sys
from typing import Dict, List, Tuple

from repro_torch.analysis import registry as _registry
from repro_torch.analysis.config import (
    AnalysisConfig,
    allowed,
    find_repo_root,
    line_markers,
)
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.programs import DEFAULT_PROGRAMS, simulator_program

#: Ops whose result the host reads: a scalar read (``.item()``,
#: ``bool(t)``, ``int(t)``), a boolean result, or an output whose size
#: depends on the data (on the card each waits for the device).
HOST_READ_OPS = frozenset({"_local_scalar_dense", "nonzero", "masked_select",
                           "equal"})

#: Output dtypes TX102 flags.
WIDE_DTYPES = frozenset({"float64", "complex32", "complex64", "complex128"})

_SKIP_DIRS = (os.path.join("src", "repro_torch", "roofline"),
              os.path.join("src", "repro_torch", "analysis"))


@dataclasses.dataclass(frozen=True)
class Site:
    """One flagged op: its loop bucket, its ``file:line`` (``""``, 0 when
    no frame of the repository ran it) and the op's name."""

    bucket: int
    path: str
    line: int
    op: str


@dataclasses.dataclass(frozen=True)
class Walk:
    """One program's walk. ``buckets[k]`` is bucket ``k``'s op multiset
    as sorted ``(name, count)`` pairs; ``host_reads`` the walker's host
    reads; ``launches`` the kernel launches the wrappers counted during
    the walk; ``program`` the ``(fn, args)`` walked."""

    iterations: int
    buckets: Tuple[Tuple[Tuple[str, int], ...], ...]
    host_reads: Tuple[Site, ...]
    wide: Tuple[Site, ...]
    launches: Tuple[Tuple[str, int], ...]
    program: tuple = dataclasses.field(compare=False, repr=False)

    def full(self) -> List[Dict[str, int]]:
        """The full iterations' op multisets, in order."""
        return [dict(b) for b in self.buckets[1:-1]]

    def kernels(self, bucket: int) -> Dict[str, int]:
        return {k[len("kernel."):]: n for k, n in self.buckets[bucket]
                if k.startswith("kernel.")}


class _Attribution:
    """Where an op of the program runs: the innermost frame of the
    caller's stack in a file under ``root`` outside ``roofline/`` and
    ``analysis/``, searched up to the frame that ran the program
    (``stop``); ``("", 0)`` when there is none."""

    def __init__(self, root: str, stop):
        self.root, self.stop = root, stop
        self.skip = tuple(os.path.join(root, d) + os.sep for d in _SKIP_DIRS)
        self.paths: Dict[object, str] = {}   # code object -> rel path or ""

    def _path(self, code) -> str:
        rel = self.paths.get(code)
        if rel is None:
            fn = os.path.abspath(code.co_filename)
            rel = (os.path.relpath(fn, self.root).replace(os.sep, "/")
                   if fn.startswith(self.root + os.sep)
                   and not fn.startswith(self.skip) else "")
            self.paths[code] = rel
        return rel

    def __call__(self) -> Tuple[str, int]:
        f = sys._getframe(1)
        while f is not None and f is not self.stop:
            rel = self._path(f.f_code)
            if rel:
                return rel, f.f_lineno
            f = f.f_back
        return "", 0


def _launch_counters() -> tuple:
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.kernels import ssm_scan
    from repro_torch.kernels.map_fused import ops as mf
    from repro_torch.kernels.phase1_map import ops as p1

    return (mf.LAUNCHES, p1.LAUNCHES, flash_attention.LAUNCHES,
            decode_attention.LAUNCHES, ssm_scan.LAUNCHES)


def _launches() -> Dict[str, int]:
    return {k: v for d in _launch_counters() for k, v in d.items()}


def _program_key(params):
    """A hashable key of one program: the callable itself, or the
    builder's arguments with its defaults filled in."""
    if callable(params):
        return params
    bound = inspect.signature(simulator_program).bind(**params)
    bound.apply_defaults()
    return tuple((k, tuple(v) if isinstance(v, list) else v)
                 for k, v in bound.arguments.items() if k != "device")


def _device(device) -> str:
    from repro_torch.core.device import resolve_device

    return str(resolve_device(device))


def walk_program(params, device=None, root=None) -> Walk:
    """Walk one program (a :func:`simulator_program` kwargs dict, or a
    zero-arg callable returning ``(fn, args)``, so tests can audit
    seeded-bad programs) once on ``device``. A walk is kept for the
    process: the checks share it."""
    return _walk(_program_key(params), _device(device),
                 os.path.abspath(root or find_repo_root()))


@functools.lru_cache(maxsize=32)
def _walk(key, device: str, root: str) -> Walk:
    import torch

    from repro_torch.core import engine
    from repro_torch.roofline.walk import Walker, tensors

    fn, args = key() if callable(key) else simulator_program(
        device=device, **dict(key))
    on_card = torch.device(device).type == "cuda"
    where = _Attribution(root, sys._getframe())
    start = engine.COUNTS["loop_iterations"]
    buckets: Dict[int, collections.Counter] = collections.defaultdict(
        collections.Counter)
    reads: List[Site] = []
    wide: List[Site] = []
    wide_dtypes = {getattr(torch, n) for n in WIDE_DTYPES}
    names: Dict[object, Tuple[str, bool]] = {}   # op -> (name, host read)

    def visit(op):
        b = engine.COUNTS["loop_iterations"] - start
        buckets[b][op.func] += 1
        name, read = names.get(op.func) or names.setdefault(
            op.func, (op.name, op.name in HOST_READ_OPS))
        outs = ((op.out,) if isinstance(op.out, torch.Tensor)
                else tensors(op.out))
        if read or (on_card and any(
                t.device.type == "cpu" for t in outs) and any(
                t.device.type == "cuda" for t in tensors((op.args,
                                                          op.kwargs)))):
            reads.append(Site(b, *where(), name))
        if any(t.dtype in wide_dtypes for t in outs):
            wide.append(Site(b, *where(), name))

    def kernel_visit(name, _cost, _path):
        b = engine.COUNTS["loop_iterations"] - start
        buckets[b][f"kernel.{name}"] += 1

    def named(counts):
        out = collections.Counter()
        for k, v in counts.items():
            out[k if isinstance(k, str) else
                f"{k.namespace}.{k.overloadpacket.__name__}"] += v
        return tuple(sorted(out.items()))

    before = _launches()
    with Walker(visit, kernel_visit, track_bytes=False):
        fn(*args)
    n = engine.COUNTS["loop_iterations"] - start
    launched = {k: v - before[k] for k, v in _launches().items()}
    return Walk(
        iterations=n,
        buckets=tuple(named(buckets[k]) for k in range(n + 1)),
        host_reads=tuple(reads), wide=tuple(wide),
        launches=tuple(sorted((k, v) for k, v in launched.items() if v)),
        program=(fn, args))


def sync_sites(params, device=None, root=None) -> Tuple[Site, ...]:
    """Run the walked program again, without the walker, under PyTorch's
    sync debug mode, and return each synchronizing call's site (the card
    only; ``()`` elsewhere). It sees inside the kernel wrappers, which
    the walker does not."""
    device = _device(device)
    if device.split(":")[0] != "cuda":
        return ()
    return _syncs(_program_key(params), device,
                  os.path.abspath(root or find_repo_root()))


@functools.lru_cache(maxsize=32)
def _syncs(key, device: str, root: str) -> Tuple[Site, ...]:
    import warnings

    import torch

    from repro_torch.core import engine

    fn, args = _walk(key, device, root).program

    where = _Attribution(root, sys._getframe())
    start = engine.COUNTS["loop_iterations"]
    sites: List[Site] = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            # where the warning points (the innermost Python caller), for
            # a sync no frame of the program made
            sites.append(Site(engine.COUNTS["loop_iterations"] - start,
                              *where(), f"sync at {filename}:{lineno}"))

    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    return tuple(sites)


def describe(walk: Walk, syncs=()) -> dict:
    """What phase 8i prints and compares for one walk: iterations, ops
    per bucket, the first full iteration's kernel scopes, the walker's
    host reads and the sync debug mode's ``syncs`` by ``file:line``
    (every bucket), and kernel launches."""
    def by_line(sites):
        c = collections.Counter(f"{s.path}:{s.line}" if s.path
                                else f"(no frame of the program: {s.op})"
                                for s in sites)
        return dict(sorted(c.items()))

    return {"iterations": walk.iterations,
            "ops": [sum(n for _, n in b) for b in walk.buckets],
            "kernels_per_iteration": walk.kernels(1),
            "host_reads": by_line(walk.host_reads),
            "syncs": by_line(syncs),
            "launches": dict(walk.launches)}


def summary(device=None) -> dict:
    """:func:`describe` of every default program walked on ``device``,
    with its syncs on the card."""
    return {name: describe(walk_program(params, device),
                           sync_sites(params, device))
            for name, params in DEFAULT_PROGRAMS}


def _no_torch(check, rule) -> List[Finding]:
    return [Finding(
        path=f"walk:{check}", line=0, rule=rule, check=check,
        message="torch unavailable — Layer 2 runs the engine")]


def _torch_missing() -> bool:
    try:
        import torch  # noqa: F401
    except ImportError:
        return True
    return False


class _Markers:
    """The ``allow`` annotations of the files findings point at, parsed
    once per check run; an annotation without a reason is a finding."""

    def __init__(self, cfg: AnalysisConfig, check):
        self.cfg, self.check = cfg, check
        self.files: Dict[str, dict] = {}
        self.unexplained: Dict[Tuple[str, int], Finding] = {}

    def covers(self, path: str, line: int, marker: str) -> bool:
        if not line:                      # no frame of the repository
            return False
        if path not in self.files:
            with open(os.path.join(self.cfg.root, path)) as fh:
                self.files[path] = line_markers(fh.read())[0]
        hit = allowed(self.files[path], line, marker)
        if hit is None:
            return False
        if not hit[1]:
            self.unexplained[(path, hit[0])] = Finding(
                path=path, line=hit[0], rule=self.check.rule,
                check=self.check.name,
                message=(f"allow-{marker} without a [reason] — "
                         "explain the suppression"))
        return True


def _site_findings(check, cfg, sites_by_program, marker: str,
                   what: str) -> List[Finding]:
    """One finding per unmarked ``file:line`` among the sites of full
    iterations, naming the ops and the programs."""
    markers = _Markers(cfg, check)
    grouped: Dict[Tuple[str, int], dict] = {}
    for pname, sites in sites_by_program:
        for s in sites:
            loc = (s.path or f"walk:{pname}", s.line)
            g = grouped.setdefault(loc, {"ops": collections.Counter(),
                                         "programs": []})
            g["ops"][s.op] += 1
            if pname not in g["programs"]:
                g["programs"].append(pname)
    out = []
    for (path, line), g in sorted(grouped.items()):
        if markers.covers(path, line, marker):
            continue
        ops = ", ".join(f"{op} x{n}" for op, n in sorted(g["ops"].items()))
        out.append(Finding(
            path=path, line=line, rule=check.rule, check=check.name,
            message=(f"{what} in full iterations of the loop ({ops}; "
                     f"{', '.join(g['programs'])})")))
    return out + list(markers.unexplained.values())


def _full_sites(walk: Walk, sites) -> List[Site]:
    return [s for s in sites if 0 < s.bucket < walk.iterations]


def _pair(fleets, tag="", **params):
    return tuple((f"{f}/FELARE{tag}", dict(fleet=f, heuristic="FELARE",
                                           **params)) for f in fleets)


#: TX101's fleet groups, JX101's three, each compared on its own as
#: ``((program name, params), ...)``: the paper pair, the tiered pair
#: with the network attached, and the paper pair on the kernels.
FLATNESS_GROUPS = (
    _pair(("paper_x2", "paper_x32")),
    _pair(("tiered_x4", "tiered_x16"), "+net", dispatcher="tier_aware",
          network="tiered"),
    _pair(("paper_x2", "paper_x32"), "+fused", fused=True),
)


@dataclasses.dataclass(frozen=True)
class FlatnessCheck:
    """TX101: each full iteration's op multiset is the same across F.

    The groups of :data:`FLATNESS_GROUPS` are compared independently, as
    JX101 compares them. Iterations are compared position by position
    over the iterations both walks ran.
    """

    name: str = "walk-flatness"
    rule: str = "TX101"
    layer: int = 2

    def run(self, cfg: AnalysisConfig) -> List[Finding]:
        if _torch_missing():
            return _no_torch(self.name, self.rule)
        out: List[Finding] = []
        for group in FLATNESS_GROUPS:
            walks = [(name, walk_program(p, cfg.device, cfg.root))
                     for name, p in group]
            out += compare_full_iterations(self, walks)
        return out


def compare_full_iterations(check, walks) -> List[Finding]:
    """Findings where a walk's full iteration differs from the first
    walk's at the same position: one per differing op, at the first
    such iteration."""
    (n0, w0), rest = walks[0], walks[1:]
    out = []
    for n1, w1 in rest:
        for k, (a, b) in enumerate(zip(w0.full(), w1.full()), start=1):
            if a == b:
                continue
            for op in sorted(set(a) | set(b)):
                if a.get(op, 0) != b.get(op, 0):
                    out.append(Finding(
                        path=f"walk:{n1}", line=0, rule=check.rule,
                        check=check.name,
                        message=(f"iteration {k}'s op multiset differs at "
                                 f"{op}: {b.get(op, 0)} at {n1} vs "
                                 f"{a.get(op, 0)} at {n0}")))
            break
    return out


@dataclasses.dataclass(frozen=True)
class DtypeCheck:
    """TX102: no float64/complex output in a full iteration (or marked)."""

    name: str = "walk-dtype"
    rule: str = "TX102"
    layer: int = 2

    def run(self, cfg: AnalysisConfig) -> List[Finding]:
        if _torch_missing():
            return _no_torch(self.name, self.rule)
        sites = []
        for pname, params in DEFAULT_PROGRAMS:
            w = walk_program(params, cfg.device, cfg.root)
            sites.append((pname, _full_sites(w, w.wide)))
        return _site_findings(self, cfg, sites, "f64",
                              "float64/complex output")


@dataclasses.dataclass(frozen=True)
class HostSyncAuditCheck:
    """TX103: no host read in a full iteration; the same kernels in each.
    """

    name: str = "walk-host-sync"
    rule: str = "TX103"
    layer: int = 2

    def run(self, cfg: AnalysisConfig) -> List[Finding]:
        if _torch_missing():
            return _no_torch(self.name, self.rule)
        sites, out = [], []
        for pname, params in DEFAULT_PROGRAMS:
            w = walk_program(params, cfg.device, cfg.root)
            syncs = sync_sites(params, cfg.device, cfg.root)
            sites.append((pname, _full_sites(w, w.host_reads + syncs)))
            first = w.kernels(1)
            for k in range(2, w.iterations):
                if w.kernels(k) != first:
                    out.append(Finding(
                        path=f"walk:{pname}", line=0, rule=self.rule,
                        check=self.name,
                        message=(f"iteration {k}'s kernel scopes "
                                 f"{w.kernels(k)} differ from iteration "
                                 f"1's {first}")))
                    break
        return _site_findings(self, cfg, sites, "sync",
                              "host read") + out


for _name, _check in [
    ("walk-flatness", FlatnessCheck()),
    ("walk-dtype", DtypeCheck()),
    ("walk-host-sync", HostSyncAuditCheck()),
]:
    _registry.register(_name, _check)
del _name, _check
