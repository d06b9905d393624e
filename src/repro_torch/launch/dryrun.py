"""Multi-pod dry run: one rank's step of every (arch x shape x mesh) cell
on a production mesh, counted by the roofline walker (counterpart of
``repro/launch/dryrun.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
      --shape train_4k --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
Each cell appends one JSON line to ``<out>/cells.jsonl`` (per-rank cost,
collective bytes, memory, the roofline row), so an interrupted sweep
resumes where it stopped.

The reference fakes 512 XLA devices and compiles each cell. The port
joins a *fake* process group of 256 (``pod``: (16, 16) over data, model)
or 512 ranks (``multipod``: (2, 16, 16) over pod, data, model) in this
one process, as rank 0 (``launch.mesh.init_fake_group``), builds
``make_production_mesh`` on it as a CPU mesh whose shards are ``meta``
tensors (``distributed.sharding.on_meta``), and runs rank 0's train
step, prefill or decode step once, through ``make_train_step(mesh=)`` /
``make_serve_steps(mesh=)``, under the walker: parameters, optimizer
state, batch and caches are ``DTensor`` s over ``meta`` shards, so
nothing is allocated and collectives return at once. Serving runs the
config's kernels (their cost rules are counted on ``meta`` inputs, with
``kv_len`` taken as the whole cache); training the plain paths.

Per-rank work is counted as rank 0 runs it. The reference divides a
global count by the chips; the port's ranks along ``model`` compute the
same rows (ROADMAP B9), so rank 0's count is the world-size-1 count over
the data-parallel width, not over the chips. Each cell records both:
``cost`` (rank 0) and ``flops_global_over_chips`` (the world-size-1
count, also run on ``meta``, over the chips).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.configs import shapes as shp
from repro_torch.datapipe.synthetic import input_specs
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import PRODUCTION_SHAPES, init_fake_group
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import AdamW
from repro_torch.roofline import analysis as ra
from repro_torch.roofline import cost as rc
from repro_torch.roofline.walk import nbytes, tensors
from repro_torch.train.steps import (
    TRAIN_IMPLS,
    make_serve_steps,
    make_train_step,
)

DEFAULT_ACCUM = {"train_4k": 8}


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def serve_batch_specs(cfg, shape) -> dict:
    """A prefill cell's inputs as ``meta`` tensors."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "audio":
        return {"frames": _meta((B, S // 2, cfg.d_model), torch.bfloat16),
                "tokens": _meta((B, S // 2), torch.int32)}
    if cfg.family == "vlm":
        return {"tokens": _meta((B, S - cfg.n_patches), torch.int32),
                "patches": _meta((B, cfg.n_patches, cfg.d_model),
                                 torch.bfloat16)}
    return {"tokens": _meta((B, S), torch.int32)}


def decode_specs(cfg, shape) -> tuple:
    """A decode cell's cache and tokens as ``meta`` tensors."""
    B, S = shape.global_batch, shape.seq_len
    max_seq = S // 2 if cfg.family == "audio" else S
    return (tf.init_cache(cfg, B, max_seq, device="meta"),
            _meta((B, 1), torch.int32))


def cell_step(cfg, shape, mesh=None, accum: int | None = None) -> tuple:
    """``(fn, args)``: one step of the cell, on ``mesh`` (its shards on
    ``meta``; arguments as ``DTensor`` s in the reference's layouts) or,
    with ``mesh=None``, on one ``meta`` device (the world-size-1 count).
    ``cfg`` as given for serving; training takes the plain paths."""
    pshapes = tf.param_shapes(cfg)
    if shape.kind == "train":
        cfg = cfg.scaled(**TRAIN_IMPLS)
        opt = AdamW()
        batch = input_specs(cfg, shape, accum=accum or DEFAULT_ACCUM.get(
            shape.name, 8))
        if mesh is None:
            step = make_train_step(cfg, opt, donate=False, device="meta")
            params = pshapes
        else:
            step = make_train_step(cfg, opt, mesh, donate=False)
            params = sh.distribute(pshapes, step.param_shardings)
            batch = sh.distribute(batch, sh.batch_sharding(
                mesh, batch, accum_dim=True))
        return step, (params, opt.init(params), batch)
    if shape.kind == "prefill":
        batch = serve_batch_specs(cfg, shape)
        max_seq = (shape.seq_len // 2 if cfg.family == "audio"
                   else shape.seq_len)
        if mesh is None:
            prefill, _ = make_serve_steps(cfg, device="meta")
            return (lambda p, b: prefill(p, b, max_seq=max_seq),
                    (pshapes, batch))
        prefill_jit_for, _ = make_serve_steps(cfg, mesh)
        params = sh.distribute(pshapes, sh.param_shardings(pshapes, mesh,
                                                           cfg))
        return (prefill_jit_for(batch, max_seq),
                (params, sh.distribute(batch, sh.batch_sharding(mesh,
                                                                batch))))
    cache, tokens = decode_specs(cfg, shape)
    if mesh is None:
        _, decode = make_serve_steps(cfg, device="meta")
        return decode, (pshapes, cache, tokens)
    _, decode_jit_for = make_serve_steps(cfg, mesh)
    params = sh.distribute(pshapes, sh.param_shardings(pshapes, mesh, cfg))
    return (decode_jit_for(cache, tokens),
            (params, sh.distribute(cache, sh.cache_sharding(cfg, mesh,
                                                            cache)),
             sh.distribute(tokens, sh.batch_sharding(mesh, tokens))))


def _bytes(tree) -> int:
    return sum(nbytes(t) for t in tensors(tree))


def _counts(c: dict) -> dict:
    return {k: c[k] for k in ("flops", "bytes", "matmul_flops")}


def lower_cell(arch: str, shape_name: str, mesh, mesh_name: str,
               accum: int | None = None, cfg=None) -> dict:
    """Rank 0's step of one cell on ``mesh`` (a ``DeviceMesh`` over a fake
    group, marked ``sharding.on_meta``) under the walker: its record, with
    ``status`` ``ok``, ``skip`` (``configs.shapes.applicable``) or
    ``fail`` (the error and the walker's findings: the op that stopped
    the step and its path)."""
    cfg = cfg or registry.get_config(arch)
    shape = shp.SHAPES[shape_name]
    head = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    ok, reason = shp.applicable(cfg, shape_name)
    if not ok:
        return {**head, "status": "skip", "reason": reason}
    sh.on_meta(mesh)
    chips = mesh.size()
    t0 = time.perf_counter()
    try:
        fn, args = cell_step(cfg, shape, mesh, accum)
        result, c = rc.measure(fn, *args)
        trace_s = time.perf_counter() - t0
        fn1, args1 = cell_step(cfg, shape, None, accum)
        one = rc.cost(fn1, *args1)
    except Exception as e:           # a failed cell is a finding: record it
        return {**head, "status": "fail", "chips": chips,
                "error": f"{type(e).__name__}: {e}"[:500],
                "findings": getattr(e, "findings", [])}
    arg_b = _bytes(args)
    mem = {"argument_bytes": arg_b, "output_bytes": _bytes(result),
           "peak_live_bytes": arg_b + c["peak_bytes"]}
    roof = ra.from_cost(arch, shape_name, mesh_name, chips, c,
                        ra.model_flops_for(cfg, shape),
                        peak_mem=mem["peak_live_bytes"])
    return {**head, "status": "ok", "chips": chips,
            "trace_s": round(trace_s, 2),
            "cost": _counts(c), "by_kernel": c["by_kernel"],
            "collective_bytes": c["collectives"], "memory": mem,
            "roofline": roof.row(),
            "flops_global_over_chips": {k: v / chips for k, v in
                                        _counts(one).items()},
            "findings": c["findings"]}


def production_mesh(mesh_name: str):
    """A fake group of the production mesh's ranks, joined in this
    process as rank 0 (any group before it is left), and the mesh on it:
    ``pod`` (16, 16), ``multipod`` (2, 16, 16)."""
    multi = mesh_name == "multipod"
    n = 1
    for s in PRODUCTION_SHAPES[multi][0]:
        n *= s
    if dist.is_initialized():
        dist.destroy_process_group()
    init_fake_group(n)
    return make_production_mesh(multi_pod=multi, device="cpu")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=registry.ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(shp.SHAPES))
    ap.add_argument("--mesh", choices=("pod", "multipod", "both"),
                    default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--variant", choices=("base", "opt"), default="base",
                    help="opt: beyond-paper optimized config "
                         "(vocab padded to a TP-shardable multiple)")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    outfile = outdir / "cells.jsonl"
    done = set()
    if outfile.exists():
        for line in outfile.read_text().splitlines():
            try:
                r = json.loads(line)
                done.add((r["arch"], r["shape"], r["mesh"]))
            except json.JSONDecodeError:
                pass

    cells = ([(a, s) for a in registry.ARCH_IDS for s in shp.SHAPES]
             if args.all else [(args.arch, args.shape)])
    mesh_names = (["pod", "multipod"] if args.mesh == "both"
                  else [args.mesh])
    n_fail = 0
    t_all = time.perf_counter()
    try:
        for mn in mesh_names:
            todo = [c for c in cells if c + (mn,) not in done]
            for arch, shape_name in cells:
                if (arch, shape_name, mn) in done:
                    print(f"[cached] {arch} x {shape_name} x {mn}")
            if not todo:
                continue
            mesh = production_mesh(mn)
            for arch, shape_name in todo:
                print(f"[trace] {arch} x {shape_name} x {mn} ...",
                      flush=True)
                cfg = registry.get_config(arch)
                if args.variant == "opt":
                    cfg = cfg.scaled(pad_vocab_to=256)
                try:
                    rec = lower_cell(arch, shape_name, mesh, mn,
                                     accum=args.accum, cfg=cfg)
                except Exception as e:      # a crash of the dry run itself
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape_name, "mesh": mn,
                           "status": "fail",
                           "error": f"{type(e).__name__}: {e}"}
                n_fail += rec["status"] == "fail"
                with open(outfile, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                extra = (f" trace {rec['trace_s']}s, dominant "
                         f"{rec['roofline']['dominant']}"
                         if rec["status"] == "ok" else
                         f" {rec.get('reason') or rec.get('error')}")
                print(f"  -> {rec['status']}{extra}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"done in {time.perf_counter() - t_all:.1f}s; {n_fail} failures "
          f"-> {outfile}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
