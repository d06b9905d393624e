"""Layer 1: AST lint, the port's discipline rules that need no torch
(counterpart of ``repro/analysis/astlint.py``).

Six rules, each named after the reference rule it stands for:

  TD001 registry-frozen   registered objects are frozen dataclasses (or
                          NamedTuples) with hashable field types (JD001).
  TD002 rng-discipline    no seeding or drawing outside the sanctioned
                          seeded draws (:data:`RNG_SANCTIONED`): no
                          ``np.random.*`` call, ``torch.manual_seed``,
                          ``torch.Generator`` or torch random draw without
                          ``generator=`` elsewhere; an ad-hoc stream breaks
                          common-random-number pairing (JD002).
  TD003 host-effects      no ``print``/``open``/``input``/``breakpoint``,
                          ``time.*``, ``datetime.*``, ``random.*`` or
                          ``numpy.random.*`` in a stage function (JD003).
  TD004 host-sync         no ``.item()``, ``.tolist()``, ``.numpy()``,
                          ``.cpu()``, no ``bool``/``int``/``float`` of a
                          tensor and no ``if``/``while``/``assert`` on a
                          tensor in a stage function: in eager PyTorch each
                          is a device-to-host read per event (JD004).
  TD005 float32           no ``torch.float64``, ``.double()`` or
                          ``np.float64`` in ``core/``: the decision
                          arithmetic is float32 end to end (JD005 holds the
                          reference's float32 oracle to it; the port's tests
                          use that oracle, so the rule applies to the port's
                          own arithmetic).
  TD006 no-reference-import  no ``import``/``from`` of ``jax``, ``jaxlib``
                          or ``repro`` anywhere in the port
                          (:data:`IMPORT_SCOPE`): the reference's Layer 1
                          runs without JAX, the whole port does.

The scope is :data:`SCOPE_DIRS` (``core`` and ``scenarios``) except for
TD006. Everything here is pure ``ast``: it runs with ``torch``, ``jax``
and ``repro`` unimportable. Escape hatches are the ``# repro:
allow-<name>[reason]`` annotations of :mod:`repro_torch.analysis.config`
(names: ``registry``, ``rng``, ``host``, ``sync``, ``f64``, ``import``);
a marker with no ``[reason]`` is itself a finding.

"Stage function" is resolved by NAME, as the reference resolves its jit
bodies: the engine's ``_stage_*``, ``notify`` and ``run`` (the event
loop of ``_make_loop``, its set-up included), the protocol methods the
registries dispatch on (:data:`STAGE_METHODS`, the reference's set), and
any function opted in with ``# repro: jit-body`` on or above its ``def``
line. Taint for TD004 starts from the parameter names the engine passes
tensors under (:data:`TENSOR_PARAMS`) and from ``torch.*`` results;
``.shape``-style attributes, ``len()`` and ``is``/``is not`` launder. A
helper that only ever runs in the loop but matches neither net is a
coverage gap, not a false positive: mark it ``jit-body``.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis import registry as _registry
from repro_torch.analysis.config import AnalysisConfig, allowed, line_markers
from repro_torch.analysis.findings import Finding

#: Repo-relative directories the rules scan (TD006 excepted).
SCOPE_DIRS = ("src/repro_torch/core", "src/repro_torch/scenarios")

#: What TD006 scans: the whole port, the card's smoke script and the
#: port's examples.
IMPORT_SCOPE = ("src/repro_torch", "chip_smoke.py", "examples/torch_*.py")

#: Packages the port must not import.
REFERENCE_PACKAGES = frozenset({"jax", "jaxlib", "repro"})

#: Method names the engine and the registries call on every event (the
#: reference's ``JIT_BODY_METHODS``).
STAGE_METHODS = frozenset({
    "__call__", "step", "select", "nominate", "key", "drop", "dispatch",
    "on_event", "init", "finalize", "sample",
})

#: Free-function names that are stage functions: the event loop and its
#: observer hook (``_make_loop``'s inner functions).
STAGE_FUNCS = frozenset({"run", "notify"})

#: Parameter names under which the engine passes tensors (the
#: reference's traced names, and the loop's own).
TENSOR_PARAMS = frozenset({
    "st", "state", "ctx", "est", "trace", "traces", "tr", "nom", "view",
    "aux", "carry", "xs", "key", "keys", "halted_state", "suffered",
    "action", "sysarr", "avail", "pending", "task", "tasks", "mask",
    "values", "val", "qstate", "t_now", "new", "old", "halted", "active",
})

#: Call roots banned in stage functions (dotted-prefix match).
HOST_EFFECT_ROOTS = ("time.", "datetime.", "numpy.random.", "random.")
HOST_EFFECT_NAMES = frozenset({"print", "input", "open", "breakpoint"})

#: Methods that read a tensor back to the host.
HOST_READ_METHODS = frozenset({"item", "tolist", "numpy", "cpu"})

#: Field-annotation tokens that make a registry object unhashable.
UNHASHABLE_TOKENS = frozenset({
    "list", "List", "dict", "Dict", "set", "Set", "bytearray", "ndarray",
    "Array",
})


# --------------------------------------------------------------------------
# Parsing + shared per-file state
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParsedFile:
    path: str
    rel: str
    source: str
    tree: ast.AST
    allows: Dict[int, Dict[str, str]]   # line -> {marker-name: reason}
    jit_body_lines: Tuple[int, ...]     # lines carrying "# repro: jit-body"
    aliases: Dict[str, str]             # import alias -> dotted module


def _import_aliases(tree: ast.AST) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def parse_file(cfg: AnalysisConfig, path: str) -> ParsedFile:
    with open(path) as fh:
        source = fh.read()
    tree = ast.parse(source, filename=path)
    allows, jit_body = line_markers(source)
    return ParsedFile(
        path=path, rel=cfg.relpath(path).replace(os.sep, "/"),
        source=source, tree=tree, allows=allows,
        jit_body_lines=tuple(jit_body), aliases=_import_aliases(tree))


def parse_scope(cfg: AnalysisConfig,
                dirs: Sequence[str] = SCOPE_DIRS) -> List[ParsedFile]:
    return [parse_file(cfg, p) for p in cfg.python_files(*dirs)]


def _suppressed(pf: ParsedFile, lineno: int, marker: str,
                check: str, rule: str,
                out: List[Finding]) -> bool:
    """True if an ``allow-<marker>`` annotation covers ``lineno`` (same
    line or the line above). An empty ``[reason]`` still suppresses the
    original finding but emits an unexplained-suppression finding."""
    hit = allowed(pf.allows, lineno, marker)
    if hit is None:
        return False
    ln, reason = hit
    if not reason:
        out.append(Finding(
            path=pf.rel, line=ln, rule=rule, check=check,
            message=(f"allow-{marker} without a [reason] — "
                     "explain the suppression")))
    return True


def dotted_name(node: ast.AST,
                aliases: Optional[Dict[str, str]] = None) -> Optional[str]:
    """``torch.cuda.manual_seed`` for an Attribute/Name chain,
    alias-resolved (``np`` -> ``numpy``)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    root = node.id
    if aliases and root in aliases:
        root = aliases[root]
    parts.append(root)
    return ".".join(reversed(parts))


def _stage_functions(pf: ParsedFile) -> List[ast.AST]:
    """Every function node the stage rules apply to (see module doc)."""
    marked = set(pf.jit_body_lines)
    out = []
    for node in ast.walk(pf.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        name = node.name
        if (name.startswith("_stage_") or name in STAGE_FUNCS
                or name in STAGE_METHODS
                or node.lineno in marked or (node.lineno - 1) in marked):
            out.append(node)
    return out


def _body_without_nested(fn: ast.AST) -> Iterable[ast.AST]:
    """Walk a function body without descending into nested defs/lambdas
    (nested stage functions are visited in their own right)."""
    stack = list(getattr(fn, "body", []))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _finding(check, pf: ParsedFile, node: ast.AST, message: str,
             marker: str, out: List[Finding]) -> None:
    """Append ``message`` at ``node`` unless an ``allow-<marker>``
    covers its line."""
    if _suppressed(pf, node.lineno, marker, check.name, check.rule, out):
        return
    out.append(Finding(path=pf.rel, line=node.lineno, rule=check.rule,
                       check=check.name, message=message))


# --------------------------------------------------------------------------
# TD001 — registry objects must be frozen + hashable
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _ClassInfo:
    rel: str
    lineno: int
    is_dataclass: bool
    frozen: bool
    is_protocol: bool
    is_namedtuple: bool
    fields: Tuple[Tuple[str, str, int], ...]  # (name, annotation, lineno)


def _class_info(node: ast.ClassDef, rel: str) -> _ClassInfo:
    is_dc = frozen = False
    for dec in node.decorator_list:
        call = dec if isinstance(dec, ast.Call) else None
        target = call.func if call else dec
        name = dotted_name(target) or ""
        if name.split(".")[-1] == "dataclass":
            is_dc = True
            if call:
                for kw in call.keywords:
                    if (kw.arg == "frozen"
                            and isinstance(kw.value, ast.Constant)):
                        frozen = bool(kw.value.value)
    bases = {dotted_name(b) or "" for b in node.bases}
    base_tails = {b.split(".")[-1] for b in bases}
    fields = tuple(
        (stmt.target.id, ast.unparse(stmt.annotation), stmt.lineno)
        for stmt in node.body
        if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target,
                                                          ast.Name))
    return _ClassInfo(
        rel=rel, lineno=node.lineno, is_dataclass=is_dc, frozen=frozen,
        is_protocol="Protocol" in base_tails,
        is_namedtuple="NamedTuple" in base_tails, fields=fields)


def _registered_class_names(pf: ParsedFile) -> Set[str]:
    """Class names reachable from ``register(...)`` calls in this file.

    Resolves the three idioms the port uses, as the reference's rule
    does: direct ``register("x", Ctor(...))``; module-level ``X =
    Ctor(...)`` then ``register("x", X)``; and the loop idiom ``for _n,
    _x in [("x", Ctor(...)), ...]: register(_n, _x)``. Constructor calls
    NESTED in a registered expression are collected too: component
    classes are fields of the registered object and must be just as
    hashable.
    """
    assigns: Dict[str, ast.expr] = {}
    for stmt in pf.tree.body if isinstance(pf.tree, ast.Module) else ():
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)):
            assigns[stmt.targets[0].id] = stmt.value

    def classes_in(expr: ast.AST, depth: int = 0) -> Set[str]:
        found: Set[str] = set()
        if depth > 4:
            return found
        if isinstance(expr, ast.Name) and expr.id in assigns:
            return classes_in(assigns[expr.id], depth + 1)
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                name = dotted_name(node.func)
                if name and name[0].isupper():
                    found.add(name.split(".")[-1])
        return found

    loop_items: Dict[str, List[ast.expr]] = {}
    for node in ast.walk(pf.tree):
        if (isinstance(node, ast.For) and isinstance(node.target, ast.Tuple)
                and len(node.target.elts) == 2
                and isinstance(node.target.elts[1], ast.Name)
                and isinstance(node.iter, (ast.List, ast.Tuple))):
            item_var = node.target.elts[1].id
            loop_items[item_var] = [
                elt.elts[1] for elt in node.iter.elts
                if isinstance(elt, ast.Tuple) and len(elt.elts) == 2]

    out: Set[str] = set()
    for node in ast.walk(pf.tree):
        if not isinstance(node, ast.Call):
            continue
        fname = (dotted_name(node.func) or "").split(".")[-1]
        if fname not in ("register", "register_fleet") or len(node.args) < 2:
            continue
        item = node.args[1]
        if isinstance(item, ast.Name) and item.id in loop_items:
            for expr in loop_items[item.id]:
                out |= classes_in(expr)
        else:
            out |= classes_in(item)
    return out


@dataclasses.dataclass(frozen=True)
class RegistryFrozenCheck:
    """TD001: registered objects are frozen dataclasses, hashable fields."""

    name: str = "registry-frozen"
    rule: str = "TD001"
    layer: int = 1
    dirs: Tuple[str, ...] = SCOPE_DIRS

    def run(self, cfg: AnalysisConfig) -> List[Finding]:
        files = parse_scope(cfg, self.dirs)
        index: Dict[str, _ClassInfo] = {}
        for pf in files:
            for node in ast.walk(pf.tree):
                if isinstance(node, ast.ClassDef):
                    index.setdefault(node.name, _class_info(node, pf.rel))
        registered: Set[str] = set()
        for pf in files:
            registered |= _registered_class_names(pf)

        out: List[Finding] = []
        by_rel = {pf.rel: pf for pf in files}
        for cname in sorted(registered):
            info = index.get(cname)
            if info is None or info.is_protocol or info.is_namedtuple:
                continue  # helper / out-of-scope class; a NamedTuple is
                #           immutable and hashable by construction
            pf = by_rel[info.rel]
            if not (info.is_dataclass and info.frozen):
                if _suppressed(pf, info.lineno, "registry", self.name,
                               self.rule, out):
                    continue
                out.append(Finding(
                    path=info.rel, line=info.lineno, rule=self.rule,
                    check=self.name,
                    message=(f"registered class {cname} must be a "
                             "@dataclass(frozen=True) — registry objects "
                             "are shared by every simulator built from "
                             "them")))
                continue
            for fname, ann, lineno in info.fields:
                tokens = set(
                    ann.replace("[", " ").replace("]", " ")
                       .replace(".", " ").replace(",", " ").split())
                bad = tokens & UNHASHABLE_TOKENS
                if not bad or _suppressed(pf, lineno, "registry",
                                          self.name, self.rule, out):
                    continue
                out.append(Finding(
                    path=info.rel, line=lineno, rule=self.rule,
                    check=self.name,
                    message=(f"{cname}.{fname}: unhashable field type "
                             f"{ann!r} ({sorted(bad)[0]}) breaks the "
                             "registry object's hash")))
        return out


# --------------------------------------------------------------------------
# TD002 — seeded draws only in the sanctioned modules
# --------------------------------------------------------------------------

#: Modules allowed to seed and draw (repo-relative prefixes): the
#: scenarios' per-trace stream children and draws, the fleets' seeded
#: tables and the faults' counter hash.
RNG_SANCTIONED = (
    "src/repro_torch/scenarios/base.py",
    "src/repro_torch/scenarios/fleets.py",
    "src/repro_torch/core/faults/base.py",
)

_TORCH_SEEDING = frozenset({
    "torch.manual_seed", "torch.seed", "torch.Generator",
    "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
    "torch.random.manual_seed", "torch.random.seed",
})
#: torch draws that take a ``generator=``; without one they read the
#: global stream.
_TORCH_DRAWS = frozenset({
    "rand", "randn", "randint", "randperm", "bernoulli", "multinomial",
    "normal", "poisson", "rand_like", "randn_like", "randint_like",
})
#: In-place draws on a tensor (``x.uniform_()``), also ``generator=``.
_TENSOR_DRAWS = frozenset({
    "uniform_", "normal_", "bernoulli_", "random_", "exponential_",
    "geometric_", "cauchy_", "log_normal_",
})


def _rng_call(name: str, node: ast.Call) -> bool:
    if name.startswith("numpy.random.") or name in _TORCH_SEEDING:
        return True
    if any(kw.arg == "generator" for kw in node.keywords):
        return False
    if name.startswith("torch.") and name.split(".")[-1] in _TORCH_DRAWS:
        return True
    return (isinstance(node.func, ast.Attribute)
            and node.func.attr in _TENSOR_DRAWS)


@dataclasses.dataclass(frozen=True)
class RngDisciplineCheck:
    """TD002: seeding and draws only in the sanctioned modules."""

    name: str = "rng-discipline"
    rule: str = "TD002"
    layer: int = 1
    dirs: Tuple[str, ...] = SCOPE_DIRS

    def run(self, cfg: AnalysisConfig) -> List[Finding]:
        out: List[Finding] = []
        for pf in parse_scope(cfg, self.dirs):
            if any(pf.rel.startswith(p) for p in RNG_SANCTIONED):
                continue
            for node in ast.walk(pf.tree):
                if not isinstance(node, ast.Call):
                    continue
                name = dotted_name(node.func, pf.aliases) or ""
                if not _rng_call(name, node):
                    continue
                _finding(self, pf, node,
                         f"{name or node.func.attr}() outside the sanctioned "
                         "seeded draws — an ad-hoc stream breaks common-"
                         "random-number pairing across policies; draw in "
                         "scenarios.base or use faults.hash_uniform",
                         "rng", out)
        return out


# --------------------------------------------------------------------------
# TD003 — no host effects in stage functions
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HostEffectsCheck:
    """TD003: no time/np.random/print/datetime calls in stage functions."""

    name: str = "host-effects"
    rule: str = "TD003"
    layer: int = 1
    dirs: Tuple[str, ...] = SCOPE_DIRS

    def run(self, cfg: AnalysisConfig) -> List[Finding]:
        out: List[Finding] = []
        for pf in parse_scope(cfg, self.dirs):
            for fn in _stage_functions(pf):
                for node in _body_without_nested(fn):
                    if not isinstance(node, ast.Call):
                        continue
                    name = dotted_name(node.func, pf.aliases) or ""
                    if not (name in HOST_EFFECT_NAMES or any(
                            name.startswith(root)
                            for root in HOST_EFFECT_ROOTS)):
                        continue
                    _finding(self, pf, node,
                             f"host-side effect {name}() inside stage "
                             f"function {fn.name}() — it runs on every "
                             "event and stops the loop being one device "
                             "program", "host", out)
        return out


# --------------------------------------------------------------------------
# TD004 — no host reads in stage functions
# --------------------------------------------------------------------------

_LAUNDER_ATTRS = frozenset({"shape", "ndim", "dtype", "device", "is_cuda",
                            "layout", "requires_grad"})
_LAUNDER_METHODS = frozenset({"size", "dim", "numel", "element_size",
                              "stride", "is_contiguous", "data_ptr"})


class _TaintVisitor:
    """Forward taint pass over one function body.

    Names bound from tensor parameters (or from ``torch.*`` call results)
    are tainted; ``.shape``-style attribute access, ``.size()``-style
    methods, ``len()`` and ``is``/``is not`` comparisons launder. Run
    statements in source order; good enough for the straight-line tensor
    code stage functions are (that being the point of the rule).
    """

    def __init__(self, fn: ast.AST, aliases: Dict[str, str]):
        self.aliases = aliases
        self.tainted: Set[str] = set()
        args = fn.args
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)
                  + ([args.vararg] if args.vararg else [])
                  + ([args.kwarg] if args.kwarg else [])):
            if a.arg in TENSOR_PARAMS:
                self.tainted.add(a.arg)

    def is_tainted(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in _LAUNDER_ATTRS:
                return False
            return self.is_tainted(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_tainted(node.value)
        if isinstance(node, ast.BinOp):
            return self.is_tainted(node.left) or self.is_tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tainted(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.is_tainted(v) for v in node.values)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False  # `x is None` is a static structure test
            return (self.is_tainted(node.left)
                    or any(self.is_tainted(c) for c in node.comparators))
        if isinstance(node, ast.Call):
            fname = dotted_name(node.func, self.aliases) or ""
            if fname == "len":
                return False
            if isinstance(node.func, ast.Attribute):
                if node.func.attr in _LAUNDER_METHODS:
                    return False
                if fname.startswith("torch."):
                    return True
                return self.is_tainted(node.func.value)  # x.sum()
            return any(self.is_tainted(a) for a in node.args)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.is_tainted(e) for e in node.elts)
        if isinstance(node, ast.IfExp):
            return self.is_tainted(node.body) or self.is_tainted(node.orelse)
        if isinstance(node, ast.Starred):
            return self.is_tainted(node.value)
        return False

    def bind(self, target: ast.AST, tainted: bool) -> None:
        if isinstance(target, ast.Name):
            (self.tainted.add if tainted
             else self.tainted.discard)(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self.bind(e, tainted)
        elif isinstance(target, ast.Starred):
            self.bind(target.value, tainted)


@dataclasses.dataclass(frozen=True)
class HostSyncCheck:
    """TD004: no host reads or tensor branches in stage functions."""

    name: str = "host-sync"
    rule: str = "TD004"
    layer: int = 1
    dirs: Tuple[str, ...] = SCOPE_DIRS

    def run(self, cfg: AnalysisConfig) -> List[Finding]:
        out: List[Finding] = []
        for pf in parse_scope(cfg, self.dirs):
            for fn in _stage_functions(pf):
                self._scan_function(pf, fn, out)
        return out

    def _scan_function(self, pf: ParsedFile, fn: ast.AST,
                       out: List[Finding]) -> None:
        tv = _TaintVisitor(fn, pf.aliases)

        def emit(node: ast.AST, what: str) -> None:
            _finding(self, pf, node,
                     f"{what} in stage function {fn.name}() — a device-to-"
                     "host read on every event; keep the value on the "
                     "device (torch.where, masks)", "sync", out)

        def visit_stmts(stmts: Sequence[ast.stmt]) -> None:
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    continue  # nested defs scanned in their own right
                if isinstance(stmt, ast.Assign):
                    t = tv.is_tainted(stmt.value)
                    for tgt in stmt.targets:
                        tv.bind(tgt, t)
                elif isinstance(stmt, ast.AugAssign):
                    if tv.is_tainted(stmt.value):
                        tv.bind(stmt.target, True)
                elif isinstance(stmt, ast.AnnAssign) and stmt.value:
                    tv.bind(stmt.target, tv.is_tainted(stmt.value))
                elif isinstance(stmt, (ast.If, ast.While)):
                    if tv.is_tainted(stmt.test):
                        kind = "if" if isinstance(stmt, ast.If) else "while"
                        emit(stmt, f"Python `{kind}` on a tensor")
                    self._scan_expr(stmt.test, tv, emit)
                    visit_stmts(stmt.body)
                    visit_stmts(stmt.orelse)
                    continue
                elif isinstance(stmt, ast.Assert):
                    if tv.is_tainted(stmt.test):
                        emit(stmt, "`assert` on a tensor")
                self._scan_expr(stmt, tv, emit)
                if isinstance(stmt, (ast.For, ast.With, ast.Try)):
                    for body in (getattr(stmt, "body", []),
                                 getattr(stmt, "orelse", []),
                                 getattr(stmt, "finalbody", [])):
                        visit_stmts(body)

        visit_stmts(getattr(fn, "body", []))

    @staticmethod
    def _scan_expr(root: ast.AST, tv: _TaintVisitor, emit) -> None:
        """The host reads inside one statement's expressions (not inside
        the bodies of compound statements, visited on their own)."""
        stack = [root]
        while stack:
            node = stack.pop()
            if isinstance(node, ast.IfExp) and tv.is_tainted(node.test):
                emit(node, "conditional expression on a tensor")
            elif isinstance(node, ast.Call):
                f = node.func
                if (isinstance(f, ast.Attribute)
                        and f.attr in HOST_READ_METHODS and not node.args):
                    emit(node, f"`.{f.attr}()`")
                elif (isinstance(f, ast.Name)
                      and f.id in ("bool", "int", "float") and node.args
                      and tv.is_tainted(node.args[0])):
                    emit(node, f"`{f.id}()` of a tensor")
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.stmt, ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                    continue
                stack.append(child)


# --------------------------------------------------------------------------
# TD005 — float32 decision arithmetic in core/
# --------------------------------------------------------------------------

_F64_NAMES = frozenset({"torch.float64", "torch.double", "numpy.float64",
                        "numpy.double"})


@dataclasses.dataclass(frozen=True)
class Float32Check:
    """TD005: no float64 in core/'s arithmetic (or marked)."""

    name: str = "float32"
    rule: str = "TD005"
    layer: int = 1
    dirs: Tuple[str, ...] = ("src/repro_torch/core",)

    def run(self, cfg: AnalysisConfig) -> List[Finding]:
        out: List[Finding] = []
        for pf in parse_scope(cfg, self.dirs):
            for node in ast.walk(pf.tree):
                what = self._float64(node, pf.aliases)
                if what:
                    _finding(self, pf, node,
                             f"{what} — the decision arithmetic is float32 "
                             "end to end; a float64 step rounds apart from "
                             "the reference", "f64", out)
        return out

    @staticmethod
    def _float64(node: ast.AST, aliases: Dict[str, str]) -> str:
        if isinstance(node, ast.Attribute):
            name = dotted_name(node, aliases)
            if name in _F64_NAMES:
                return f"{name} reference"
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            if node.func.attr == "double" and not node.args:
                return "`.double()` upcast"
            if (node.func.attr == "astype" and node.args
                    and isinstance(node.args[0], ast.Name)
                    and node.args[0].id == "float"):
                return "astype(float) upcast"
        return ""


# --------------------------------------------------------------------------
# TD006 — the port imports no JAX and nothing of the reference
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NoReferenceImportCheck:
    """TD006: no import of jax, jaxlib or repro anywhere in the port."""

    name: str = "no-reference-import"
    rule: str = "TD006"
    layer: int = 1
    dirs: Tuple[str, ...] = IMPORT_SCOPE

    def run(self, cfg: AnalysisConfig) -> List[Finding]:
        out: List[Finding] = []
        for pf in parse_scope(cfg, self.dirs):
            for node in ast.walk(pf.tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and not node.level:
                    mods = [node.module or ""]
                else:
                    continue
                for mod in mods:
                    if mod.split(".")[0] in REFERENCE_PACKAGES:
                        _finding(self, pf, node,
                                 f"import of {mod} — the port runs without "
                                 "JAX and keeps its own copy of what it "
                                 "needs from the reference", "import", out)
        return out


# --------------------------------------------------------------------------
# Registration — the registry idiom, applied to the analyzer itself.
# --------------------------------------------------------------------------

for _name, _check in [
    ("registry-frozen", RegistryFrozenCheck()),
    ("rng-discipline", RngDisciplineCheck()),
    ("host-effects", HostEffectsCheck()),
    ("host-sync", HostSyncCheck()),
    ("float32", Float32Check()),
    ("no-reference-import", NoReferenceImportCheck()),
]:
    _registry.register(_name, _check)
del _name, _check
