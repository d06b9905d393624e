"""One visitor over every aten op a function runs: the walk that the
roofline and the port's discipline checks share (counterpart of
``repro/roofline/jaxpr_walk.py``).

The reference walks a traced jaxpr and needs the static trip count of
each ``scan`` to weight its body. The port runs its programs eagerly:
a layer loop is a Python loop, so every trip runs and is seen, and the
multiplier is always 1. :class:`Walker` is a ``TorchDispatchMode``: each
op that reaches the dispatcher while it is active is run, then handed
to ``visit(op)`` as an :class:`Op`, which carries the op, its inputs and
outputs and its ``path``, the ``nn.Module`` names and
``record_function`` scopes it ran under (outermost first). The backward
pass and the recomputation of per-block remat run through the
dispatcher too, so they are visited like the forward.

**The kernel scope.** Each of the port's seven kernel wrappers is
decorated with :func:`kernel`. While a walker is active, no op inside a
wrapper is visited; the wrapper's cost rule is handed to
``kernel_visit(name, cost, path)`` once instead, whichever route runs:
the plain version on the CPU, the CUDA kernel on the card, or, when the
inputs are ``meta`` tensors, nothing (the wrapper returns empty ``meta``
outputs of the kernel's shapes; with no walker active it raises on
``meta`` inputs as before).

**Live bytes.** The walker tracks the storages the ops allocate while it
is active, from their first op until they are freed, and keeps the
peak: ``peak_bytes`` is what the function needed beyond its arguments.
A walker made with ``track_bytes=False`` tracks nothing (``peak_bytes``
stays 0) and walks more than twice as fast: the discipline checks read
ops, not memory.

**Findings.** An op that raises (a host read of a ``meta`` tensor, such
as ``.item()``, ``bool(t)`` or ``nonzero``, the data-dependent ops that
stop a dry run) is recorded in ``findings`` with its path before the
error goes on.

**Meta outputs.** On ``meta`` tensors an op computes nothing but its
outputs' shapes, dtypes and strides, and PyTorch takes hundreds of
microseconds for each through its Python reference implementations. A
functional op (no alias, no mutation) whose inputs are all ``meta``
gives the same outputs for the same input specs and arguments, so the
walker keeps them by that key and makes the next call's outputs
directly: a per-token loop (the sLSTM's, 4096 trips per layer in a dry
run's train step) then walks at Python speed.
"""
from __future__ import annotations

import dataclasses
import functools
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_leaves

#: The walkers now active, innermost last.
_ACTIVE: list["Walker"] = []

_RF_ENTER = ("_record_function_enter", "_record_function_enter_new")
_RF_EXIT = "_record_function_exit"


@dataclasses.dataclass(frozen=True)
class Op:
    """One op as the walker saw it. ``name`` is the overload packet's
    (``"mm"``, ``"add_"``, ``"all_gather_into_tensor"``), ``namespace``
    its library (``"aten"``, ``"_c10d_functional"``, ``"c10d"``)."""
    func: object
    args: tuple
    kwargs: dict
    out: object
    path: tuple

    @property
    def name(self) -> str:
        return self.func.overloadpacket.__name__

    @property
    def namespace(self) -> str:
        return self.func.namespace

    @property
    def is_view(self) -> bool:
        """Whether the op returns a view of an input and writes nothing
        (``view``, ``transpose``, ``expand``, ``slice``, ``select``,
        ``as_strided``, ...)."""
        rets = self.func._schema.returns
        return bool(rets) and all(
            r.alias_info is not None and not r.alias_info.is_write
            for r in rets)


@dataclasses.dataclass(frozen=True)
class Finding:
    """An op that raised under the walker, with where it ran."""
    op: str
    path: tuple
    error: str

    def row(self) -> dict:
        return {"op": self.op, "path": "/".join(self.path),
                "error": self.error}


def local(t):
    """A ``DTensor``'s local shard (the rank's own work), else ``t``."""
    inner = getattr(t, "_local_tensor", None)
    return t if inner is None else inner


def tensors(tree) -> list:
    """Every tensor leaf of ``tree``, a ``DTensor`` as its local shard."""
    return [local(x) for x in tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


def nbytes(t) -> int:
    """Bytes of ``t``'s elements (not of its storage)."""
    t = local(t)
    return t.numel() * t.element_size()


class Walker(TorchDispatchMode):
    """Visit every op run while active (see the module's docstring).

    visit(op: Op) for each op outside a kernel scope; kernel_visit(name,
    cost: dict, path) once per outermost kernel scope.
    """

    def __init__(self, visit=None, kernel_visit=None, track_bytes=True):
        super().__init__()
        self.visit = visit
        self.kernel_visit = kernel_visit
        self.track_bytes = track_bytes
        self.path: list[str] = []
        self.kernel_depth = 0
        self.findings: list[Finding] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._tracked: dict[int, int] = {}
        self._hooks: list = []
        self._meta_outs: dict = {}

    # -- scopes ------------------------------------------------------------
    def __enter__(self):
        _ACTIVE.append(self)
        mods = torch.nn.modules.module
        self._hooks = [
            mods.register_module_forward_pre_hook(self._module_enter),
            mods.register_module_forward_hook(self._module_exit,
                                              always_call=True)]
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            for h in self._hooks:
                h.remove()
            _ACTIVE.remove(self)

    def _module_enter(self, module, _args):
        self.path.append(type(module).__name__)

    def _module_exit(self, module, _args, _out):
        if self.path:
            self.path.pop()

    # -- the ops -------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket.__name__
        if func.namespace == "profiler":
            if packet in _RF_ENTER:
                self.path.append(str(args[0]))
            elif packet == _RF_EXIT and self.path:
                self.path.pop()
            return func(*args, **kwargs)
        try:
            key = _meta_key(func, args, kwargs)
            spec = None if key is None else self._meta_outs.get(key)
            if spec is not None:
                out = _from_spec(spec)
            else:
                out = func(*args, **kwargs)
                if key is not None:
                    self._meta_outs[key] = _spec(out)
        except Exception as e:
            self.findings.append(Finding(f"{func.namespace}.{packet}",
                                         tuple(self.path),
                                         f"{type(e).__name__}: {e}"[:300]))
            raise
        if self.track_bytes:
            self._track(args, kwargs, out)
        if self.kernel_depth == 0 and self.visit is not None:
            self.visit(Op(func, args, kwargs, out, tuple(self.path)))
        return out

    def _track(self, args, kwargs, out) -> None:
        """Start tracking each output storage that no input shares (a new
        allocation), until it is freed."""
        seen = {t.untyped_storage()._cdata for t in tensors((args, kwargs))}
        for t in tensors(out):
            s = t.untyped_storage()
            key = s._cdata
            if key in seen or key in self._tracked:
                continue
            n = s.nbytes()
            self._tracked[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(s, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._tracked.pop(key, 0)


def _functional(func) -> bool:
    """Whether ``func`` neither mutates nor aliases anything (cached on
    the overload)."""
    f = _FUNCTIONAL.get(func)
    if f is None:
        schema = func._schema
        f = not schema.is_mutable and all(
            r.alias_info is None for r in schema.returns) and all(
            a.alias_info is None for a in schema.arguments) and \
            torch.Tag.nondeterministic_seeded not in func.tags
        _FUNCTIONAL[func] = f
    return f


_FUNCTIONAL: dict = {}
_ATOMS = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.memory_format, torch.layout)


def _meta_key(func, args, kwargs):
    """The key of a functional op on ``meta`` inputs (each tensor's shape,
    stride and dtype, every other argument's value), or ``None`` when the
    op or an argument does not qualify."""
    if not _functional(func):
        return None
    first = args[0] if args else None
    if isinstance(first, torch.Tensor) and (
            type(first) is not torch.Tensor or first.device.type != "meta"):
        return None         # the common case off ``meta``, without a flatten
    leaves, spec = tree_flatten((args, kwargs))
    key = [func, spec.num_leaves]
    for x in leaves:
        if isinstance(x, torch.Tensor):
            if type(x) is not torch.Tensor or x.device.type != "meta":
                return None
            key.append((tuple(x.shape), x.stride(), x.dtype))
        elif isinstance(x, _ATOMS):
            key.append(x)
        else:
            return None
    return tuple(key)


def _spec(out):
    """What :func:`_from_spec` needs to make ``out`` again, or ``None``
    when it is not one ``meta`` tensor or a tuple of them."""
    outs = out if isinstance(out, tuple) else (out,)
    if not all(type(t) is torch.Tensor and t.device.type == "meta"
               for t in outs):
        return None
    return (isinstance(out, tuple),
            tuple((tuple(t.shape), t.stride(), t.dtype) for t in outs))


def _from_spec(spec):
    is_tuple, parts = spec
    outs = tuple(torch.empty_strided(shape, stride, dtype=dtype,
                                     device="meta")
                 for shape, stride, dtype in parts)
    return outs if is_tuple else outs[0]


class _KernelScope:
    """Inside it the walkers visit no op; entering counts the kernel's
    rule once, with every walker's ops of the rule itself unseen."""

    def __init__(self, walkers, name, rule, args, kwargs):
        self.walkers, self.name = walkers, name
        self.rule, self.args, self.kwargs = rule, args, kwargs

    def __enter__(self):
        outer = [w for w in self.walkers
                 if w.kernel_depth == 0 and w.kernel_visit is not None]
        paths = [tuple(w.path) for w in outer]
        for w in self.walkers:
            w.kernel_depth += 1
            w.path.append(self.name)
        if outer:
            cost = self.rule(*self.args, **self.kwargs)
            for w, path in zip(outer, paths):
                w.kernel_visit(self.name, cost, path)

    def __exit__(self, *exc):
        for w in self.walkers:
            w.kernel_depth -= 1
            w.path.pop()
        return False


def kernel(name: str, rule, meta):
    """Decorator of a kernel wrapper: the kernel scope. With no walker
    active the wrapper runs as written (the cost: one list test). With
    one, its ops go unvisited and ``rule(*args, **kwargs)``, the work the
    function defines, is counted once instead, whichever route runs; on
    ``meta`` inputs ``meta(*args, **kwargs)`` gives its outputs' shapes
    and dtypes, empty."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _ACTIVE:
                return fn(*args, **kwargs)
            with _KernelScope(tuple(_ACTIVE), name, rule, args, kwargs):
                if is_meta(*tensors((args, kwargs))):
                    return meta(*args, **kwargs)
                return fn(*args, **kwargs)
        return wrapper
    return wrap


def is_meta(*ts) -> bool:
    """True when every tensor given lies on the ``meta`` device."""
    return all(local(t).device.type == "meta" for t in ts)


def walk(fn, *args, visit=None, kernel_visit=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a :class:`Walker`; returns
    ``(result, walker)``."""
    w = Walker(visit, kernel_visit)
    with w:
        out = fn(*args, **kwargs)
    return out, w


def op_counts(fn, *args, **kwargs) -> dict:
    """``{"namespace.op": count}`` of every op ``fn`` runs, each kernel
    scope counted once under its name (counterpart of
    ``jaxpr_walk.primitive_counts``; here a loop's body counts once per
    trip, since every trip runs)."""
    counts: dict = {}

    def visit(op):
        k = f"{op.namespace}.{op.name}"
        counts[k] = counts.get(k, 0) + 1

    def kernel_visit(name, _cost, _path):
        k = f"kernel.{name}"
        counts[k] = counts.get(k, 0) + 1

    walk(fn, *args, visit=visit, kernel_visit=kernel_visit, **kwargs)
    return counts
