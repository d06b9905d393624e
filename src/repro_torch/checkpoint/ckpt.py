"""Checkpointing: atomic, async, content-hashed (counterpart of
``repro/checkpoint/ckpt.py``), in the reference's on-disk layout, so a
checkpoint written by either package restores in the other.

Layout: <dir>/step_<N:08d>/
  arrays.npz      leaves a0, a1, ... in ``jax.tree.leaves`` order, on the
                  host; bfloat16 stored as its uint16 bits
  meta.json       step, time, the leaves' ``jax.tree_util.keystr`` names,
                  their original dtypes and shapes, the blake2b digest
  (written to a tmp dir and renamed: a crash mid-write never corrupts the
  latest checkpoint)

bfloat16 is read back from its bits without ``ml_dtypes``. Leaves are
matched by name at restore, so a tree of nested dicts and an
``AdamWState`` in the port names its leaves as the reference's pytree
does (``['p']['embed']['tok']``, ``['o'].mu['embed']['tok']``).

Sharded trees: :func:`save` of a tree with ``DTensor`` leaves is a
collective (every rank calls it): the leaves are gathered whole and rank
0 alone writes them, in the same layout. :func:`restore` with
``shardings`` (a matching tree of ``distributed.sharding.Layout`` s)
returns ``DTensor`` s, each rank keeping its own shard of the whole
leaves it reads: a checkpoint saved on one mesh restores on any other,
bit for bit.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil
import threading
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import tree as tr


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_host(leaf) -> tuple:
    """(the array as written, its original dtype name, shape): a host copy
    of a tensor, bfloat16 as its uint16 bits."""
    t = torch.as_tensor(leaf).detach()
    t = t.to("cpu", copy=True)      # device->host; a copy on the CPU too
    name = _dtype_name(t)
    if t.dtype == torch.bfloat16:
        a = t.view(torch.int16).numpy().view(np.uint16)
    else:
        a = t.numpy()
    return a, name, list(t.shape)


def _bytes(a: np.ndarray) -> np.ndarray:
    """The array's bytes, C order, as a flat uint8 view (no copy when it
    is contiguous)."""
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _digest(arrs) -> str:
    h = hashlib.blake2b(digest_size=16)
    for a in arrs:
        h.update(_bytes(a))
    return h.hexdigest()


def _load(path, n: int) -> tuple:
    """The ``n`` arrays of ``path`` and their digest; each array is hashed
    in a second thread while the next one is read."""
    h = hashlib.blake2b(digest_size=16)
    arrs, pending = [], None
    with ThreadPoolExecutor(1) as pool, np.load(path) as z:
        for i in range(n):
            arrs.append(z[f"a{i}"])
            if pending is not None:
                pending.result()
            pending = pool.submit(h.update, _bytes(arrs[-1]))
        if pending is not None:
            pending.result()
    return arrs, h.hexdigest()


def save(path, step: int, tree, *,
         blocking: bool = True) -> threading.Thread | None:
    """Write the checkpoint of ``step``. Every leaf is copied to host
    memory before this returns, so the caller may update its tensors in
    place at once; ``blocking=False`` then writes the files from a
    background thread and returns it (join it before the next save).

    ``DTensor`` leaves are gathered whole (every rank of their mesh calls
    ``save``); only rank 0 writes, and a blocking save returns on every
    rank once the checkpoint is published. Other ranks return ``None``.
    """
    sharded = any(isinstance(x, DTensor) for x in tr.leaves(tree))
    names, arrs, dtypes, shapes = [], [], [], []
    for name, leaf in tr.named_leaves(tree):
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        if sharded and dist.get_rank() != 0:
            continue
        a, dt, shp = _to_host(leaf)
        names.append(name)
        arrs.append(a)
        dtypes.append(dt)
        shapes.append(shp)

    def _write():
        base = pathlib.Path(path)
        base.mkdir(parents=True, exist_ok=True)
        final = base / f"step_{step:08d}"
        tmp = base / f".tmp_step_{step:08d}_{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        with ThreadPoolExecutor(1) as pool:     # hash while writing
            digest = pool.submit(_digest, arrs)
            np.savez(tmp / "arrays.npz",
                     **{f"a{i}": a for i, a in enumerate(arrs)})
            meta = {"step": step, "time": time.time(), "names": names,
                    "dtypes": dtypes, "shapes": shapes,
                    "digest": digest.result()}
        (tmp / "meta.json").write_text(json.dumps(meta))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish

    if sharded and dist.get_rank() != 0:
        if blocking:
            dist.barrier()
        return None
    if blocking:
        _write()
        if sharded:
            dist.barrier()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def latest_step(path) -> int | None:
    base = pathlib.Path(path)
    if not base.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in base.glob("step_*")]
    return max(steps) if steps else None


def _from_host(a: np.ndarray, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16).reshape(shape)).view(
                torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).reshape(shape))


def restore(path, target, *, step: int | None = None, shardings=None,
            verify: bool = True, device=None):
    """Restore into the structure of ``target`` (a tree of tensors, on any
    device, ``meta`` included). Returns (tree, step): the leaves on
    ``device`` (``None``: the CPU), each with the shape and dtype of its
    target leaf. ``shardings``: a matching tree of
    ``distributed.sharding.Layout`` s; the leaves then come back as
    ``DTensor`` s in them, on their mesh's device (every rank reads the
    files). Raises IOError on a corrupt container or digest, KeyError on
    a missing leaf and ValueError on a leaf of another shape or dtype.
    """
    base = pathlib.Path(path)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    d = base / f"step_{step:08d}"
    meta = json.loads((d / "meta.json").read_text())
    try:
        arrs, digest = _load(d / "arrays.npz", len(meta["names"]))
    except (OSError, ValueError, KeyError, EOFError,
            zipfile.BadZipFile) as e:
        raise IOError(
            f"checkpoint digest/container corrupt at step {step}: {e}"
        ) from e
    if verify and digest != meta["digest"]:
        raise IOError(f"checkpoint digest mismatch at step {step}")
    by_name = dict(zip(meta["names"],
                       zip(arrs, meta["dtypes"], meta["shapes"])))
    missing = [n for n, _ in tr.named_leaves(target) if n not in by_name]
    if missing:
        raise KeyError(f"checkpoint missing leaves: {missing[:5]}...")
    dev = torch.device("cpu") if device is None else torch.device(device)

    def _checked(name, want):
        t = _from_host(*by_name[name])
        if tuple(t.shape) != tuple(want.shape) or t.dtype != want.dtype:
            raise ValueError(f"{name}: checkpoint holds {t.dtype} "
                             f"{tuple(t.shape)}, the target {want.dtype} "
                             f"{tuple(want.shape)}")
        return t

    def load(name, want):
        return _checked(name, want).to(dev)

    if shardings is None:
        return tr.map_named(load, target), step
    from repro_torch.distributed import sharding as sh

    layouts = dict(zip((n for n, _ in tr.named_leaves(target)),
                       tr.leaves(shardings)))
    return tr.map_named(lambda name, want: sh.shard(
        _checked(name, want), layouts[name]), target), step
