"""Sharding rules: parameter / batch / cache specs, their DTensor
placements, and the sweep grid (counterpart of
``repro/distributed/sharding.py``).

A rule gives the reference's ``PartitionSpec`` as a plain tuple, one
entry per tensor dim: ``None``, a mesh axis name, or a tuple of names
(major to minor) for a dim split over several axes. A one-axis entry is
written as the name (JAX's ``P(("data",)) == P("data")``). A
:class:`Layout` pairs a spec with a mesh; its ``placements`` are the
``DTensor`` placements on a ``DeviceMesh``: ``Shard(dim)`` on every mesh
dim that an entry names, ``Replicate()`` on the others. Rules take a
``DeviceMesh`` or, for the shapes alone, a dict of axis sizes in mesh
order (``{"pod": 2, "data": 16, "model": 16}``).

Layout (the reference's DESIGN.md §5):
  * params: FSDP over ``data`` (one matmul dim), TP over ``model``
    (heads / ffn-inner / vocab), replicated over ``pod``;
  * batch: sharded over (``pod``, ``data``);
  * decode caches: batch over (``pod``, ``data``); KV heads over
    ``model`` when divisible, otherwise KV *sequence* over ``model``;
  * MoE experts: EP over ``model``.
Scanned layer stacks carry one leading (layer) dim, never sharded.

``DTensor`` accepts shards of unequal size and JAX does not, so every
spec passes :func:`_valid`'s divisibility check, as the reference's
``NamedSharding`` s do, and the shards here are always even.

The sweep (``experiments.run_sweep(..., shard=True)``) splits its flat
(rate x replicate) trace batch over :func:`sweep_devices`, each slice
padded by :func:`pad_batch`.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import tree as tr
from repro_torch.core.device import resolve_device

# leaf-name -> spec for the *trailing* dims (scan dims padded with None).
# (data, model) = (FSDP, TP).
_NAME_RULES: dict[str, tuple] = {
    "tok": ("model", "data"),        # (V, d): vocab TP'd for the LM head
    "unembed": ("data", "model"),
    "wq": ("data", "model"),
    "wk": ("data", "model"),
    "wv": ("data", "model"),
    "wo": ("model", "data"),
    "bq": ("model",),
    "bk": ("model",),
    "bv": ("model",),
    "router": ("data", None),
    "in_proj": ("data", "model"),
    "out_proj": ("model", "data"),
    "w_in": ("data", "model"),
    "w_out": ("model", "data"),
    "w_if": ("data", None),
    "b_up": ("model",),
}
_SCANNED = ("blocks", "enc_blocks")
_DP_AXES = ("pod", "data")


def _moe_aware(name: str, ndim: int):
    """w_gate/w_up/w_down appear in both dense MLP (2D) and MoE (3D)."""
    if name in ("w_gate", "w_up"):
        return ("model", "data", None) if ndim == 3 else ("data", "model")
    if name == "w_down":
        return ("model", None, "data") if ndim == 3 else ("model", "data")
    return None


# --------------------------------------------------------------------------
# trees, meshes and placements
# --------------------------------------------------------------------------
def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def map_path(fn, tree, *rest, path=()):
    """``fn(path, leaf, *rest_leaves)`` over the dicts and NamedTuples of
    ``tree`` (a spec tuple is a leaf); ``path`` is the tuple of keys and
    field names down to the leaf. ``rest`` are trees of the same
    structure."""
    if isinstance(tree, dict):
        return {k: map_path(fn, v, *(r[k] for r in rest),
                            path=path + (str(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_path(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest),
                                     path=path + (f,))
                            for f in tree._fields))
    return fn(path, tree, *rest)


def mesh_axes(mesh) -> dict:
    """{axis name: size} in mesh order, of a ``DeviceMesh`` or a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _names(entry) -> tuple:
    return () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))


def _entry(names):
    names = tuple(names)
    return None if not names else names[0] if len(names) == 1 else names


def to_placements(spec: tuple, mesh) -> tuple:
    """The ``DTensor`` placements of ``spec`` on ``mesh``: ``Shard(d)`` on
    each mesh dim that entry ``d`` names, ``Replicate()`` elsewhere. An
    entry that names several axes splits its dim major to minor, which
    is the order of the mesh's dims; another order raises."""
    axes = list(mesh_axes(mesh))
    out = [Replicate()] * len(axes)
    for dim, entry in enumerate(spec):
        idx = [axes.index(a) for a in _names(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} lists its axes out of "
                             f"the mesh's order {tuple(axes)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"axis {axes[i]!r} shards two dims of "
                                 f"{spec!r}")
            out[i] = Shard(dim)
    return tuple(out)


def from_placements(placements, mesh, ndim: int) -> tuple:
    """The spec of ``placements`` on a tensor of ``ndim`` dims (the inverse
    of :func:`to_placements`)."""
    per_dim = [[] for _ in range(ndim)]
    for axis, pl in zip(mesh_axes(mesh), placements):
        if isinstance(pl, Shard):
            per_dim[pl.dim].append(axis)
        elif not isinstance(pl, Replicate):
            raise ValueError(f"{pl!r}: only Shard and Replicate have a spec")
    return tuple(_entry(a) for a in per_dim)


@dataclasses.dataclass(frozen=True)
class Layout:
    """A spec on a mesh: the counterpart of ``NamedSharding``."""
    mesh: object          # a DeviceMesh, or a dict of axis sizes
    spec: tuple

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)

    def rows(self) -> "Layout":
        """This layout with only its data-parallel axes: a rank's rows,
        every other dim whole."""
        return Layout(self.mesh, tuple(
            _entry(a for a in _names(e) if a in _DP_AXES)
            for e in self.spec))


# --------------------------------------------------------------------------
# the rules
# --------------------------------------------------------------------------
def param_spec(path, shape) -> tuple:
    """The reference's spec of the parameter at ``path`` (its keys)."""
    name = path[-1] if path else ""
    scan = 1 if any(n in _SCANNED for n in path) else 0
    ndim = len(shape) - scan
    rule = _moe_aware(name, ndim)
    if rule is None:
        rule = _NAME_RULES.get(name)
    if rule is None or len(rule) != ndim:
        rule = (None,) * ndim  # replicate (norms, convs, scalars, gates)
    return (None,) * scan + tuple(rule)


def param_specs(params_shapes):
    return map_path(lambda path, leaf: param_spec(path, leaf.shape),
                    params_shapes)


def _valid(spec: tuple, shape, mesh) -> tuple:
    """Drop spec entries that don't divide the dim (safety net)."""
    sizes = mesh_axes(mesh)
    fixed = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                          - len(spec))):
        size = 1
        for a in _names(entry):
            size *= sizes[a]
        fixed.append(entry if entry is not None and dim % size == 0
                     else None)
    return tuple(fixed)


def _attn_overrides(cfg, mesh) -> dict:
    """Head-divisibility-aware TP for attention projections: projections
    whose head count doesn't divide the TP width fall back to FSDP-only
    (a fused head dim split across heads makes the (B, S, H*hd) ->
    (B, S, H, hd) reshape cross shards)."""
    tp = mesh_axes(mesh).get("model", 1)
    if cfg is None or tp == 1:
        return {}
    over = {}
    if cfg.n_heads % tp:
        over.update({"wq": ("data", None), "wo": (None, "data"),
                     "bq": (None,)})
    if cfg.n_kv_heads % tp:
        over.update({"wk": ("data", None), "wv": ("data", None),
                     "bk": (None,), "bv": (None,)})
    return over


def param_shardings(params_shapes, mesh, cfg=None):
    """A tree of :class:`Layout` s for the parameter tree (any leaves with
    ``.shape``: ``transformer.param_shapes(cfg)``, tensors, DTensors)."""
    over = _attn_overrides(cfg, mesh)

    def one(path, leaf):
        spec = param_spec(path, leaf.shape)
        name = path[-1] if path else ""
        if name in over:
            scan = 1 if any(n in _SCANNED for n in path) else 0
            spec = (None,) * scan + tuple(over[name])
        return Layout(mesh, _valid(spec, leaf.shape, mesh))
    return map_path(one, params_shapes)


def opt_state_shardings(params_shapes, mesh, cfg=None):
    """Adam mu/nu mirror the param layout; step is replicated."""
    from repro_torch.optim.adamw import AdamWState

    pspecs = param_shardings(params_shapes, mesh, cfg)
    return AdamWState(step=Layout(mesh, ()), mu=pspecs, nu=pspecs)


def batch_axes(mesh) -> tuple:
    """The data-parallel mesh axes (pod included when present)."""
    sizes = mesh_axes(mesh)
    return tuple(a for a in _DP_AXES if a in sizes)


def dp_size(mesh) -> int:
    sizes, n = mesh_axes(mesh), 1
    for a in batch_axes(mesh):
        n *= sizes[a]
    return n


def batch_sharding(mesh, batch_shapes, accum_dim: bool = False):
    """Layouts of a batch (a tree, or one leaf): rows over the DP axes
    when they divide them (dim 1 under ``accum_dim``, the microbatch
    rows of (A, mb, ...)), everything else replicated."""
    dp, n_dp = batch_axes(mesh), dp_size(mesh)

    def one(_, leaf):
        shape = leaf.shape
        b_idx = 1 if accum_dim else 0
        spec = [None] * len(shape)
        if shape[b_idx] % n_dp == 0 and n_dp > 1:
            spec[b_idx] = _entry(dp)
        return Layout(mesh, tuple(spec))

    return map_path(one, batch_shapes)


def cache_sharding(cfg, mesh, cache_shapes):
    """Decode-cache layouts: batch over DP axes; heads-or-seq over model."""
    dp, n_dp = batch_axes(mesh), dp_size(mesh)
    tp = mesh_axes(mesh).get("model", 1)

    def one(path, leaf):
        name = path[-1] if path else ""
        shape = leaf.shape
        spec = [None] * len(shape)
        if name in ("len", "xlen"):
            return Layout(mesh, tuple(spec))
        # leading layer-stack dim then batch
        b_idx = 1 if len(shape) >= 2 else 0
        if shape[b_idx] % n_dp == 0 and n_dp > 1:
            spec[b_idx] = _entry(dp)
        if name in ("k", "v", "xk", "xv") and len(shape) == 5:
            # (L, B, S, Hkv, hd): heads over model if divisible, else seq
            if shape[3] % tp == 0:
                spec[3] = "model"
            elif shape[2] % tp == 0:
                spec[2] = "model"
        elif name == "ssm" and len(shape) == 5:
            # (L, B, H, N, P): ssm heads over model
            if shape[2] % tp == 0:
                spec[2] = "model"
        elif name == "conv" and len(shape) == 4:
            if shape[3] % tp == 0:
                spec[3] = "model"
        elif name in ("S", "n", "c", "h", "m") and len(shape) >= 4:
            # xlstm states (nsb, B, H, ...): shard widest trailing dim
            for d in range(len(shape) - 1, 1, -1):
                if shape[d] % tp == 0 and shape[d] >= tp:
                    spec[d] = "model"
                    break
        return Layout(mesh, tuple(spec))

    return map_path(one, cache_shapes)


# --------------------------------------------------------------------------
# DTensors in a layout
# --------------------------------------------------------------------------
#: Meshes whose shards are ``meta`` tensors (:func:`on_meta`).
_META_MESHES: "weakref.WeakSet" = weakref.WeakSet()


def on_meta(mesh):
    """Mark ``mesh`` (a CPU mesh, as over a fake process group) as one
    whose shards live on the ``meta`` device: shapes and dtypes, nothing
    allocated (the dry run's meshes). Returns ``mesh``."""
    _META_MESHES.add(mesh)
    return mesh


def mesh_device(mesh) -> torch.device:
    """The device of this rank's shards on ``mesh``."""
    if mesh in _META_MESHES:
        return torch.device("meta")
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_chunk(full: torch.Tensor, layout: Layout) -> torch.Tensor:
    """This rank's shard of the whole tensor ``full`` (a view): each
    ``Shard(d)`` mesh dim, in mesh order, narrows dim ``d`` to the rank's
    coordinate."""
    coord = layout.mesh.get_coordinate()
    out = full
    for i, pl in enumerate(layout.placements):
        if isinstance(pl, Shard):
            n = layout.mesh.size(i)
            step = out.shape[pl.dim] // n
            out = out.narrow(pl.dim, coord[i] * step, step)
    return out


def shard(full, layout: Layout) -> DTensor:
    """A ``DTensor`` in ``layout`` from the whole tensor, which every rank
    holds: each rank keeps a copy of its own shard (no communication)."""
    full = torch.as_tensor(full)
    dev = mesh_device(layout.mesh)
    local = local_chunk(full, layout).to(dev, copy=True).contiguous()
    return DTensor.from_local(local, layout.mesh, layout.placements,
                              run_check=False, shape=full.shape,
                              stride=_contiguous_stride(full.shape))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def distribute(tree, layouts):
    """``tree``'s whole tensors (or numpy arrays) as ``DTensor`` s in the
    matching tree of layouts."""
    return map_path(lambda _, x, lay: shard(x, lay), tree, layouts)


def _effective(placements, mesh) -> tuple:
    """``placements`` with a mesh dim of size 1 read as replicated (a
    shard over one rank is the whole dim)."""
    return tuple(pl if mesh.size(i) > 1 else Replicate()
                 for i, pl in enumerate(placements))


def gather(tree):
    """Every ``DTensor`` leaf gathered whole onto each rank (a collective:
    every rank calls it; a leaf that no mesh dim of more than one rank
    splits is its local storage, no copy); other leaves as they are."""
    def one(_, x):
        if not isinstance(x, DTensor):
            return x
        if all(isinstance(pl, Replicate)
               for pl in _effective(x.placements, x.device_mesh)):
            return x.to_local()
        return x.full_tensor()
    return map_path(one, tree)


def to_local(tree):
    """Every ``DTensor`` leaf's local shard (a view of its storage); a
    plain leaf as it is. ``tree`` may be one leaf."""
    return map_path(lambda _, x: x.to_local() if isinstance(x, DTensor)
                    else x, tree)


def like(tree, new_leaves):
    """``tree``'s structure holding ``new_leaves`` (local tensors, in
    ``tree.leaves`` order), each wrapped in the layout of the ``DTensor``
    leaf it replaces; a plain leaf's replacement as it is. The inverse of
    :func:`to_local` leaf by leaf."""
    return tr.unflatten_like(tree, [
        DTensor.from_local(n, o.device_mesh, o.placements, run_check=False,
                           shape=o.shape, stride=o.stride())
        if isinstance(o, DTensor) else n
        for o, n in zip(tr.leaves(tree), new_leaves)])


def holds_rows(x, rows: Layout) -> bool:
    """True when ``x`` is a ``DTensor`` whose local storage is already its
    rows in the rows-only layout ``rows``."""
    return isinstance(x, DTensor) and (
        _effective(x.placements, x.device_mesh)
        == _effective(rows.placements, x.device_mesh))


def to_rows(x, layout: Layout) -> torch.Tensor:
    """This rank's rows of ``x`` in ``layout``, every other dim whole: a
    ``DTensor`` is gathered over its non-DP axes (none: its own local
    storage, so in-place updates land in it); a whole tensor or array is
    sliced."""
    rows = layout.rows()
    if holds_rows(x, rows):
        return x.to_local()
    if isinstance(x, DTensor):
        return x.redistribute(x.device_mesh, rows.placements).to_local()
    t = torch.as_tensor(x)
    return local_chunk(t, rows).to(mesh_device(layout.mesh))


def from_rows(local: torch.Tensor, layout: Layout,
              rows: Layout | None = None) -> DTensor:
    """The ``DTensor`` in ``layout`` whose rows on this rank are ``local``
    (split as ``rows``, by default ``layout.rows()``: rows over the DP
    axes, other dims whole)."""
    rows = layout.rows() if rows is None else rows
    mesh = layout.mesh
    if _effective(rows.placements, mesh) == _effective(layout.placements,
                                                       mesh):
        return DTensor.from_local(local, mesh, layout.placements,
                                  run_check=False)
    dt = DTensor.from_local(local, mesh, rows.placements, run_check=False)
    return dt.redistribute(mesh, layout.placements)


def owns_replica(x: DTensor) -> bool:
    """True on exactly one rank of each group of ranks that hold the same
    shard of ``x``: those at coordinate 0 on every mesh dim where ``x`` is
    replicated. A sum over shards counts each element once that way."""
    coord = x.device_mesh.get_coordinate()
    return all(c == 0 for c, pl in zip(coord, x.placements)
               if not isinstance(pl, Shard))


def all_reduce_mesh(t: torch.Tensor, mesh, axes=None,
                    op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced in place over the mesh dims ``axes`` (``None``: all),
    one dim after another; dims of size 1 are skipped."""
    names = mesh.mesh_dim_names
    for i, name in enumerate(names):
        if (axes is None or name in axes) and mesh.size(i) > 1:
            dist.all_reduce(t, op=op, group=mesh.get_group(i))
    return t


# --------------------------------------------------------------------------
# Rows split over the data-parallel ranks, seen whole
# --------------------------------------------------------------------------
def _dp_dims(mesh) -> list:
    """The mesh dims of the data-parallel axes that hold more than one
    rank, major first."""
    dp = batch_axes(mesh)
    return [i for i, name in enumerate(mesh.mesh_dim_names)
            if name in dp and mesh.size(i) > 1]


def dp_rank(mesh) -> int:
    """This rank's place among the data-parallel ranks, major to minor:
    the order in which :func:`batch_sharding` splits rows."""
    coord, r = mesh.get_coordinate(), 0
    for i in _dp_dims(mesh):
        r = r * mesh.size(i) + coord[i]
    return r


class _GatherRows(torch.autograd.Function):
    """Dim 0 split over the data-parallel ranks gathered whole on every
    rank (minor dim first, so the rows come in the batch's order); the
    backward sums the gradient over those ranks and keeps this rank's
    rows."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        out = x.contiguous()
        for i in reversed(_dp_dims(mesh)):
            parts = [torch.empty_like(out) for _ in range(mesh.size(i))]
            dist.all_gather(parts, out, group=mesh.get_group(i))
            out = torch.cat(parts)
        return out

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_mesh(g.clone(memory_format=torch.contiguous_format),
                            ctx.mesh, batch_axes(ctx.mesh))
        return g.narrow(0, dp_rank(ctx.mesh) * ctx.rows, ctx.rows), None


def shared_rows(mesh) -> tuple:
    """``(gather, own)`` for a batch whose rows are split over the
    data-parallel ranks: ``gather(x)`` is the whole batch's rows on every
    rank (a collective; differentiable), ``own(y)`` this rank's rows of a
    whole batch's ``y`` (``models.moe.rows_shared`` takes the pair)."""
    n_dp, r = dp_size(mesh), dp_rank(mesh)

    def own(y):
        n = y.shape[0] // n_dp
        return y.narrow(0, r * n, n)

    return (lambda x: _GatherRows.apply(x, mesh)), own


# --------------------------------------------------------------------------
# Sweep-grid sharding: the (rate x replicate) Monte-Carlo batch
# --------------------------------------------------------------------------
def sweep_devices(device=None, max_devices: int | None = None):
    """The devices a sharded sweep on ``device`` (``None`` = CUDA) splits
    its batch over: every visible CUDA device, or ``None`` when there is
    only one (or ``max_devices`` caps it to one) and the caller takes the
    plain single-device path, so ``shard=True`` is always safe to ask."""
    dev = resolve_device(device)
    devs = ([torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
            if dev.type == "cuda" else [dev])
    n = len(devs) if max_devices is None else min(int(max_devices),
                                                  len(devs))
    return devs[:n] if n > 1 else None


def pad_batch(tree, multiple: int):
    """Pad every leaf's leading batch dim up to a multiple of ``multiple``.

    Padding rows repeat row 0 (a real, finite trace: the simulator runs
    it and the caller slices the padding back off), so sharding never
    requires the batch to divide the device count.
    """
    def one(_, x):
        pad = (-x.shape[0]) % multiple
        if pad == 0:
            return x
        fill = x[:1].expand((pad,) + tuple(x.shape[1:]))
        return torch.cat([x, fill], dim=0)

    return map_path(one, tree)
