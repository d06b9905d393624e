"""The port's sharded substrate on 8 and 4 gloo ranks against its
one-device path and the JAX package (``make_train_step(mesh=)``,
``make_serve_steps(mesh=)``, ``ckpt.save`` / ``restore(shardings=)``,
``interop(mesh=)``, ``launch/train.py --model-axis``).

The setup is tests/test_distributed.py's: internlm2-1.8b's smoke config
in float32, batch 8, seq 32, 2 microbatches, ``AdamW(lr=1e-3)``, on the
(2, 2, 2) (pod, data, model) mesh. One group of 8 ranks runs every
8-rank check (``rank_substrate``) and one of 4 the launcher; the
reference runs in subprocesses on 8 placeholder CPU devices, as its own
tests do. This module imports neither JAX nor the shared helpers at its
top: each rank imports it to find its function.
"""
from __future__ import annotations

import contextlib
import io

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor

from repro_torch import interop
from repro_torch import tree as tr
from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry as treg
from repro_torch.distributed import sharding as sh
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer as ttf
from repro_torch.optim.adamw import AdamW
from repro_torch.train.steps import (
    TRAIN_IMPLS,
    make_grad_step,
    make_serve_steps,
    make_train_step,
)

ARCH = "internlm2-1.8b"
B, SEQ, ACCUM, LR = 8, 32, 2, 1e-3
CLIP = 0.05                 # below the first step's norm: clipping acts
# (name, mesh shape, axes, clip_norm)
CASES = (("base", (2, 2, 2), ("pod", "data", "model"), 1.0),
         ("clip", (2, 2, 2), ("pod", "data", "model"), CLIP),
         ("dm", (4, 2), ("data", "model"), 1.0))
# (name, arch, masked): the step's whole-batch loss where a rank's mean is
# not its share of it: an MoE (its groups, capacities and load-balancing
# loss span the ranks' rows) and a batch whose mask leaves each rank a
# different token count per microbatch; on (2, 2, 2), seed-0 parameters
WHOLE_BATCH_CASES = (("moe", "granite-moe-3b-a800m", False),
                     ("mask", ARCH, True))
PROMPT, MAX_SEQ, DECODE_STEPS = 16, 64, 2
DECODE_MESHES = (("2x2x2", (2, 2, 2), ("pod", "data", "model")),
                 ("2x4", (2, 4), ("data", "model")))


def _cfg():
    return treg.get_smoke_config(ARCH).scaled(dtype="float32",
                                              param_dtype="float32")


def _numpy(tree) -> dict:
    """Name -> numpy array of every leaf, DTensors gathered whole,
    bfloat16 as its int16 bits."""
    out = {}
    for name, x in tr.named_leaves(tree):
        t = (x.full_tensor() if isinstance(x, DTensor) else x).detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        out[name] = t.cpu().numpy()
    return out


def _check_layout(tree, layouts, what: str) -> None:
    """Every leaf a DTensor in its layout's placements."""
    for (name, x), lay in zip(tr.named_leaves(tree), tr.leaves(layouts)):
        assert isinstance(x, DTensor), f"{what}{name}: {type(x)}"
        assert tuple(x.placements) == lay.placements, (
            f"{what}{name}: {x.placements} != {lay.placements}")


def _train_case(inp, shape, axes, clip):
    cfg = _cfg().scaled(**TRAIN_IMPLS)
    mesh = make_mesh(shape, axes, device="cpu")
    opt = AdamW(lr=LR, clip_norm=clip)
    params = interop.model_params_from_arrays(cfg, inp["params"], mesh=mesh)
    state = interop.opt_state_from_arrays(cfg, inp["opt"], mesh=mesh)
    step = make_train_step(cfg, opt, mesh, donate=False)
    _check_layout(params, step.param_shardings, "params")
    _check_layout(state, step.opt_shardings, "opt")
    grads, gm = step.sharded_grads(params, inp["batch"])
    _check_layout(grads, step.param_shardings, "grads")
    fn = step.jit_for(inp["batch"])
    p1, o1, m = fn(params, state, inp["batch"])
    _check_layout(p1, step.param_shardings, "params out")
    _check_layout(o1, step.opt_shardings, "opt out")
    # donate=False left the inputs as they were
    assert all(np.array_equal(a, inp["params_flat"][n]) for n, a in
               _numpy(params).items())
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "tokens": float(m["tokens"]), "grad_loss": float(gm["loss"]),
           "grads": _numpy(grads), "params": _numpy(p1),
           "mu": _numpy(o1.mu), "step": int(o1.step.full_tensor())}
    return out, (cfg, mesh, p1, o1)


def _whole_batch_setup(inp, name):
    """(config, seed-0 parameters, batch) of a ``WHOLE_BATCH_CASES``
    entry: the MoE's batch its own tokens, the masked one ``inp``'s
    tokens under ``inp``'s mask."""
    _, arch, masked = dict((c[0], c) for c in WHOLE_BATCH_CASES)[name]
    cfg = treg.get_smoke_config(arch).scaled(
        dtype="float32", param_dtype="float32", **TRAIN_IMPLS)
    batch = {"tokens": inp["batch"]["tokens"] % cfg.vocab_size}
    if masked:
        batch["mask"] = inp["mask"]
    return cfg, ttf.init(cfg, seed=0, device="cpu"), batch


def _whole_batch_case(inp, name):
    cfg, params, batch = _whole_batch_setup(inp, name)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    opt = AdamW(lr=LR)
    step = make_train_step(cfg, opt, mesh, donate=False)
    params = sh.distribute(params, step.param_shardings)
    grads, _ = step.sharded_grads(params, batch)
    p1, _, m = step(params, opt.init(params), batch)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "tokens": float(m["tokens"]), "grads": _numpy(grads),
            "params": _numpy(p1)}


def _decode_case(inp, shape, axes):
    cfg = _cfg()
    mesh = make_mesh(shape, axes, device="cpu")
    params = interop.model_params_from_arrays(cfg, inp["params"], mesh=mesh)
    pshard = sh.param_shardings(params, mesh, cfg)
    _check_layout(params, pshard, "params")
    prefill_for, decode_for = make_serve_steps(cfg, mesh)
    out = {}
    # tests/test_distributed.py:116-140: a zero cache, one decode step
    cache = ttf.init_cache(cfg, B, MAX_SEQ, device="cpu")
    toks = torch.ones((B, 1), dtype=torch.int32)
    decode = decode_for(cache, toks)
    logits, cache2 = decode(params, cache, toks)
    _check_layout(cache2, sh.cache_sharding(cfg, mesh, cache), "cache")
    assert tuple(logits.shape) == (B, 1, cfg.vocab_size)
    assert int(cache2["len"].full_tensor()[0]) == 1
    out["zero"] = logits.full_tensor().numpy()
    # a prompt, then greedy steps through the meshed cache
    batch = {"tokens": torch.from_numpy(inp["prompt"])}
    prefill = prefill_for(batch, MAX_SEQ)
    logits, cache = prefill(params, batch)
    cshard = sh.cache_sharding(cfg, mesh, cache)
    _check_layout(cache, cshard, "prefill cache")
    out["prefill"] = logits.full_tensor().numpy()
    kv = cache["k"].to_local()
    for s in range(DECODE_STEPS):
        toks = logits.full_tensor().argmax(-1).to(torch.int32)
        decode = decode_for(cache, toks)
        logits, cache = decode(params, cache, toks)
        _check_layout(cache, cshard, f"decode {s} cache")
        # the cache's shards were updated in place
        assert cache["k"].to_local().data_ptr() == kv.data_ptr()
        out[f"decode{s}"] = logits.full_tensor().numpy()
    out["cache"] = _numpy(cache)
    out["cache_specs"] = {n: lay.spec for n, lay in tr.named_leaves(cshard)}
    return out


def _elastic(inp, dirs) -> dict:
    """Save on (4, 2), restore on (2, 4) bit for bit; the reference's
    checkpoint onto a port mesh; a port checkpoint for the reference."""
    out = {}
    mesh_a = make_mesh((4, 2), ("data", "model"), device="cpu")
    mesh_b = make_mesh((2, 4), ("data", "model"), device="cpu")
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    h = (torch.arange(32, dtype=torch.float32) / 7).to(
        torch.bfloat16).reshape(4, 8)
    tree = {"w": sh.shard(w, sh.Layout(mesh_a, ("data", "model"))),
            "h": sh.shard(h, sh.Layout(mesh_a, (None, "model")))}
    assert ckpt.save(dirs["elastic"], 1, tree) is None
    target = {"w": torch.empty((8, 8), device="meta"),
              "h": torch.empty((4, 8), dtype=torch.bfloat16, device="meta")}
    lay_b = {"w": sh.Layout(mesh_b, ("data", "model")),
             "h": sh.Layout(mesh_b, ("data", None))}
    got, step = ckpt.restore(dirs["elastic"], target, shardings=lay_b)
    assert step == 1
    _check_layout(got, lay_b, "elastic")
    out["elastic"] = _numpy(got)
    out["elastic_local"] = got["w"].to_local().numpy()
    # the reference's checkpoint (saved from a (4, 2) jax mesh)
    ref, _ = ckpt.restore(dirs["from_ref"], {
        "w": torch.empty((8, 8), device="meta")},
        shardings={"w": sh.Layout(mesh_b, ("data", "model"))})
    out["from_ref"] = _numpy(ref)
    # a checkpoint of DTensors on (4, 2) for the reference to read
    ckpt.save(dirs["to_ref"], 3, {
        "w": sh.shard(w * 3, sh.Layout(mesh_a, ("data", "model"))),
        "h": sh.shard(h, sh.Layout(mesh_a, ("data", None)))})
    return out


def rank_substrate(rank, world, inp, dirs):
    out = {"train": {}, "decode": {}, "whole_batch": {}}
    for name, *_ in WHOLE_BATCH_CASES:
        out["whole_batch"][name] = _whole_batch_case(inp, name)
    for name, shape, axes, clip in CASES:
        res, state = _train_case(inp, shape, axes, clip)
        out["train"][name] = res
        if name == "base":
            # the trained state of (2, 2, 2) saved, restored on (4, 2)
            cfg, _, p1, o1 = state
            ckpt.save(dirs["state"], 1, {"p": p1, "o": o1})
            mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
            shapes = ttf.param_shapes(cfg)
            lay = {"p": sh.param_shardings(shapes, mesh, cfg),
                   "o": sh.opt_state_shardings(shapes, mesh, cfg)}
            back, _ = ckpt.restore(
                dirs["state"], {"p": shapes, "o": AdamW().init(shapes)},
                shardings=lay)
            _check_layout(back, lay, "restored state")
            out["state_restored"] = _numpy(back)
            out["state_saved"] = _numpy({"p": p1, "o": o1})
    for name, shape, axes in DECODE_MESHES:
        out["decode"][name] = _decode_case(inp, shape, axes)
    out.update(_elastic(inp, dirs))
    if rank:        # rank 0's copy is enough for the whole arrays
        out = {k: {c: {"loss": v["loss"]} for c, v in out[k].items()}
               for k in ("train", "whole_batch")}
    return out


def rank_launcher(rank, world, ckpt_dir):
    """launch/train.py under an already joined group of 4 CPU ranks."""
    runs = []
    argv = ["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
            "--steps", "3", "--batch", "4", "--seq", "16", "--ckpt",
            ckpt_dir, "--ckpt-every", "2"]
    for extra in (["--model-axis", "2"], ["--production-mesh"],
                  ["--model-axis", "3"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = launch_train.main(argv + extra)
        runs.append((rc, buf.getvalue()))
    return runs


# ------------------------------------------------------------ the setup
_REFERENCE_TRAIN = """
import numpy as np, jax, jax.numpy as jnp
import repro
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint import ckpt
from repro.configs import registry
from repro.datapipe.synthetic import SyntheticLM
from repro.launch.mesh import make_mesh
from repro.models import transformer as tf
from repro.optim.adamw import AdamW
from repro.train.steps import make_train_step

out_path, ckpt_dir = {out!r}, {ckpt_dir!r}
cfg = registry.get_smoke_config({arch!r}).scaled(
    dtype="float32", param_dtype="float32")
params = tf.init(jax.random.PRNGKey(0), cfg)
b = SyntheticLM(cfg, batch={B}, seq={SEQ}, accum={ACCUM}).batch_at(0)
out = {{"batch": b["tokens"]}}
flat = lambda t: {{jax.tree_util.keystr(p): np.asarray(x) for p, x in
                  jax.tree_util.tree_flatten_with_path(t)[0]}}
out.update({{"params" + k: v for k, v in flat(params).items()}})
for name, shape, axes, clip in {cases!r}:
    opt = AdamW(lr={LR}, clip_norm=clip)
    mesh = make_mesh(shape, axes)
    step = make_train_step(cfg, opt, mesh, donate=False)
    with mesh:
        fn = step.jit_for(jax.tree.map(
            lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), b))
        p, o, m = fn(params, opt.init(params), b)
    out[name + "/loss"] = np.asarray(m["loss"])
    out[name + "/grad_norm"] = np.asarray(m["grad_norm"])
    out.update({{name + "/p" + k: v for k, v in flat(p).items()}})
mesh_a = make_mesh((4, 2), ("data", "model"))
w = jnp.arange(64, dtype=jnp.float32).reshape(8, 8) + 0.25
ckpt.save(ckpt_dir, 1, {{"w": jax.device_put(
    w, NamedSharding(mesh_a, P("data", "model")))}})
np.savez(out_path, **out)
"""

_REFERENCE_RESTORE = """
import numpy as np, jax, jax.numpy as jnp
import repro
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint import ckpt
from repro.launch.mesh import make_mesh

mesh_b = make_mesh((2, 4), ("data", "model"))
sh = {{"w": NamedSharding(mesh_b, P("data", "model")),
      "h": NamedSharding(mesh_b, P(None, "model"))}}
target = {{"w": jax.ShapeDtypeStruct((8, 8), jnp.float32),
          "h": jax.ShapeDtypeStruct((4, 8), jnp.bfloat16)}}
got, step = ckpt.restore({d!r}, target, shardings=sh)
assert step == 3 and got["w"].sharding == sh["w"]
np.testing.assert_array_equal(
    np.asarray(got["w"]), np.arange(64, dtype=np.float32).reshape(8, 8) * 3)
want = (jnp.arange(32, dtype=jnp.float32) / 7).astype(
    jnp.bfloat16).reshape(4, 8)
assert np.asarray(got["h"]).tobytes() == np.asarray(want).tobytes()
print("OK")
"""


def _params_tree(flat: dict) -> dict:
    """The reference's flat "['a']['b']" names back into nested dicts."""
    tree: dict = {}
    for name, a in flat.items():
        keys = [k.strip("'") for k in name.strip("[]").split("][")]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = a
    return tree


@pytest.fixture(scope="module")
def substrate(tmp_path_factory):
    import test_torch_common as tc

    tmp = tmp_path_factory.mktemp("substrate")
    dirs = {k: str(tmp / k) for k in ("elastic", "from_ref", "to_ref",
                                      "state")}
    ref_path = tmp / "ref.npz"
    tc.run_reference(_REFERENCE_TRAIN.format(
        out=str(ref_path), ckpt_dir=dirs["from_ref"], arch=ARCH, B=B,
        SEQ=SEQ, ACCUM=ACCUM, LR=LR, cases=CASES), devices=8)
    with np.load(ref_path) as z:
        ref = dict(z)
    params_flat = {k[len("params"):]: v for k, v in ref.items()
                   if k.startswith("params[")}
    zeros = _params_tree({k: np.zeros_like(v)
                          for k, v in params_flat.items()})
    rng = np.random.default_rng(1)
    inp = {"params": _params_tree(params_flat), "params_flat": params_flat,
           "opt": _OptArrays(np.zeros((), np.int32), zeros, zeros),
           "batch": {"tokens": ref["batch"]},
           "prompt": rng.integers(0, _cfg().vocab_size, (B, PROMPT)
                                  ).astype(np.int32),
           "mask": (rng.random(ref["batch"].shape) < 0.6).astype(
               np.float32)}
    ranks = tc.spawn_group("test_torch_distributed:rank_substrate", 8, tmp,
                           args=(inp, dirs))
    restored = tc.run_reference(_REFERENCE_RESTORE.format(d=dirs["to_ref"]),
                                devices=8)
    return inp, ref, ranks, restored


class _OptArrays:
    """The reference's initial ``AdamWState`` as numpy arrays (what
    ``interop.opt_state_from_arrays`` reads: step, mu, nu)."""

    def __init__(self, step, mu, nu):
        self.step, self.mu, self.nu = step, mu, nu


def _single(inp, clip):
    """The port's one-device step on the same arrays."""
    cfg = _cfg().scaled(**TRAIN_IMPLS)
    opt = AdamW(lr=LR, clip_norm=clip)
    params = interop.model_params_from_arrays(cfg, inp["params"],
                                              device="cpu")
    grads, gm = make_grad_step(cfg, "cpu")(params, inp["batch"])
    p, o, m = make_train_step(cfg, opt, donate=False, device="cpu")(
        params, opt.init(params), inp["batch"])
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "tokens": float(m["tokens"]), "grads": _numpy(grads),
            "params": _numpy(p), "mu": _numpy(o.mu)}


# ------------------------------------------------------------ training
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_sharded_train_step_matches_single_device(substrate, case):
    inp, _, ranks, _ = substrate
    clip = dict((c[0], c[3]) for c in CASES)[case]
    got, want = ranks[0]["train"][case], _single(inp, clip)
    for r in ranks:                     # metrics are replicated
        assert r["train"][case]["loss"] == got["loss"]
    assert abs(got["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"])
    assert abs(got["grad_loss"] - want["loss"]) <= 1e-6 * abs(want["loss"])
    assert abs(got["grad_norm"] - want["grad_norm"]) <= \
        1e-5 * want["grad_norm"]
    assert got["tokens"] == want["tokens"] == B * (SEQ - 1)
    assert got["step"] == 1
    for name, g in want["grads"].items():
        bound = 1e-5 * np.abs(g).max()
        assert np.abs(got["grads"][name] - g).max() <= bound, name
    for name, p in want["params"].items():
        np.testing.assert_allclose(got["params"][name], p, rtol=0,
                                   atol=2e-3, err_msg=name)
    for name, m in want["mu"].items():
        np.testing.assert_allclose(got["mu"][name], m, rtol=0,
                                   atol=1e-5 * np.abs(m).max() + 1e-30,
                                   err_msg=name)
    if case == "clip":
        # the first moment is (1 - b1) x the gradient scaled by
        # clip / norm: clipping acted on the global norm
        assert want["grad_norm"] > CLIP
        scale = CLIP / got["grad_norm"]
        for name, g in want["grads"].items():
            np.testing.assert_allclose(
                got["mu"][name], 0.1 * g * scale, rtol=0,
                atol=1e-5 * np.abs(0.1 * g * scale).max() + 1e-30)


@pytest.mark.parametrize("case", [c[0] for c in WHOLE_BATCH_CASES])
def test_sharded_train_step_is_the_whole_batch_step(substrate, case):
    """The MoE's and the masked batch's sharded step against the port's
    one-device step over the whole batch, at the base case's bounds."""
    inp, _, ranks, _ = substrate
    got = ranks[0]["whole_batch"][case]
    cfg, params, batch = _whole_batch_setup(inp, case)
    opt = AdamW(lr=LR)
    grads, _ = make_grad_step(cfg, "cpu")(params, batch)
    p1, _, m = make_train_step(cfg, opt, donate=False, device="cpu")(
        params, opt.init(params), batch)
    for r in ranks:                     # metrics are replicated
        assert r["whole_batch"][case]["loss"] == got["loss"]
    want = float(m["loss"])
    assert abs(got["loss"] - want) <= 1e-6 * abs(want)
    assert abs(got["grad_norm"] - float(m["grad_norm"])) <= \
        1e-5 * float(m["grad_norm"])
    assert got["tokens"] == float(m["tokens"])
    if case == "mask":
        # each rank's rows hold another count of tokens per microbatch
        counts = batch["mask"][:, :, :-1].sum(-1)
        assert len(np.unique(counts)) > 1
    for name, g in _numpy(grads).items():
        bound = 1e-5 * np.abs(g).max()
        assert np.abs(got["grads"][name] - g).max() <= bound, name
    for name, p in _numpy(p1).items():
        np.testing.assert_allclose(got["params"][name], p, rtol=0,
                                   atol=2e-3, err_msg=name)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_sharded_train_step_matches_reference_sharded(substrate, case):
    _, ref, ranks, _ = substrate
    got = ranks[0]["train"][case]
    assert abs(got["loss"] - float(ref[f"{case}/loss"])) < 1e-4
    assert abs(got["grad_norm"] - float(ref[f"{case}/grad_norm"])) <= \
        1e-4 * float(ref[f"{case}/grad_norm"])
    for name, p in got["params"].items():
        np.testing.assert_allclose(p, ref[f"{case}/p{name}"], atol=2e-3,
                                   rtol=2e-2, err_msg=name)


# ------------------------------------------------------------ serving
def _unsharded_decode(inp):
    cfg = _cfg()
    params = interop.model_params_from_arrays(cfg, inp["params"],
                                              device="cpu")
    prefill, decode = make_serve_steps(cfg, device="cpu")
    out = {}
    cache = ttf.init_cache(cfg, B, MAX_SEQ, device="cpu")
    out["zero"] = decode(params, cache, torch.ones((B, 1),
                                                   dtype=torch.int32))[0]
    logits, cache = prefill(params, {"tokens": torch.from_numpy(
        inp["prompt"])}, max_seq=MAX_SEQ)
    out["prefill"] = logits
    for s in range(DECODE_STEPS):
        logits, cache = decode(params, cache,
                               logits.argmax(-1).to(torch.int32))
        out[f"decode{s}"] = logits
    out = {k: v.numpy() for k, v in out.items()}
    out["cache"] = _numpy(cache)
    return out


@pytest.mark.parametrize("mesh", [m[0] for m in DECODE_MESHES])
def test_sharded_serve_matches_unsharded(substrate, mesh):
    inp, _, ranks, _ = substrate
    got, want = ranks[0]["decode"][mesh], _unsharded_decode(inp)
    for k in ("zero", "prefill") + tuple(f"decode{s}"
                                         for s in range(DECODE_STEPS)):
        bound = 1e-5 * np.abs(want[k]).max()
        assert np.abs(got[k] - want[k]).max() <= bound, k
    for name, c in want["cache"].items():
        if c.dtype.kind == "f":
            bound = 1e-5 * max(np.abs(c).max(), 1e-30)
            assert np.abs(got["cache"][name] - c).max() <= bound, name
        else:
            np.testing.assert_array_equal(got["cache"][name], c, name)
    specs = got["cache_specs"]
    assert specs["['len']"] == (None,)
    if mesh == "2x2x2":         # 2 kv heads over a model axis of 2
        assert specs["['k']"] == (None, ("pod", "data"), None, "model",
                                  None)
    else:                       # 2 kv heads over 4: sequence over model
        assert specs["['k']"] == (None, "data", "model", None, None)


# ------------------------------------------------------------ checkpoints
def test_elastic_restore_across_meshes(substrate):
    _, _, ranks, restored = substrate
    got = ranks[0]
    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    assert got["elastic"]["['w']"].tobytes() == w.tobytes()
    h = (torch.arange(32, dtype=torch.float32) / 7).to(
        torch.bfloat16).reshape(4, 8)
    assert got["elastic"]["['h']"].tobytes() == \
        h.view(torch.int16).numpy().tobytes()
    # rank 0 of (2, 4) holds rows 0-3 and columns 0-1
    np.testing.assert_array_equal(got["elastic_local"], w[:4, :2])
    # the trained state of (2, 2, 2) restored on (4, 2), bit for bit
    for name, a in got["state_saved"].items():
        assert got["state_restored"][name].tobytes() == a.tobytes(), name
    # both packages read each other's sharded checkpoints
    assert got["from_ref"]["['w']"].tobytes() == (w + 0.25).tobytes()
    assert "OK" in restored


# ------------------------------------------------------------ launcher
@pytest.fixture(scope="module")
def launcher(tmp_path_factory):
    import test_torch_common as tc

    tmp = tmp_path_factory.mktemp("launcher")
    runs = tc.spawn_group("test_torch_distributed:rank_launcher", 4, tmp,
                          args=(str(tmp / "ckpt"),))
    return tmp, runs


def test_launch_train_model_axis_on_four_ranks(launcher, capsys):
    tmp, runs = launcher
    rc, out = runs[0][0]
    assert rc == 0
    lines = out.splitlines()
    assert lines[0].startswith("device=cpu attn_impl=plain")
    assert lines[1].startswith("arch=") and "devices=4" in lines[1]
    assert lines[2].startswith("step     0 loss ")
    assert lines[-1].startswith("step     2 loss ")
    for r in runs[1:]:
        assert r[0] == (0, "")        # only rank 0 prints
    assert ckpt.latest_step(tmp / "ckpt") == 3
    assert (tmp / "ckpt" / "step_00000002").is_dir()
    # the same run on one device: the same state up to reduction order.
    # The smoke config is bf16, so each rank's weight gradients are
    # rounded to bf16 over its own rows before the float32 sum. Adam's
    # first steps move a parameter by about lr x sign(g), so where g is
    # at that rounding's level its sign may differ: the parameters are
    # held at tests/test_distributed.py's tolerance (atol 2e-3, rtol
    # 2e-2), the moments (g and g * g) within 5 % of their largest
    assert launch_train.main(["--arch", "qwen1.5-0.5b", "--smoke",
                              "--device", "cpu", "--steps", "3", "--batch",
                              "4", "--seq", "16", "--ckpt",
                              str(tmp / "one")]) == 0
    capsys.readouterr()
    cfg = treg.get_smoke_config("qwen1.5-0.5b").scaled(**TRAIN_IMPLS)
    target = {"p": ttf.param_shapes(cfg)}
    target["o"] = AdamW().init(target["p"])
    a, _ = ckpt.restore(tmp / "ckpt", target)
    b, _ = ckpt.restore(tmp / "one", target)
    for (name, x), y in zip(tr.named_leaves(a), tr.leaves(b)):
        x, y = x.float().numpy(), y.float().numpy()
        if name.startswith("['p']"):
            np.testing.assert_allclose(x, y, atol=2e-3, rtol=2e-2,
                                       err_msg=name)
        else:
            assert np.abs(x - y).max() <= 5e-2 * max(np.abs(y).max(),
                                                     1e-30), name


def test_launch_train_refuses_meshes_the_group_cannot_hold(launcher):
    _, runs = launcher
    for rank in runs:
        for rc, out in rank[1:]:
            assert rc == 2
            assert out.startswith("error: ")
    assert "256 ranks" in runs[0][1][1]
    assert "does not divide" in runs[0][2][1]


def test_train_loop_refuses_a_mesh():
    from repro_torch.train.loop import TrainJob, run

    with pytest.raises(NotImplementedError,
                       match="exercised via launch/train.py"):
        run(TrainJob(cfg=_cfg(), steps=1, mesh=object(), device="cpu"))


def test_mesh_helpers_refuse_without_a_group(monkeypatch):
    """Outside ``torchrun`` and without a store there is no group to
    join, and no mesh without a group; the backend follows the device."""
    from repro_torch.launch import mesh as mesh_mod

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        mesh_mod.init_distributed("cpu")
    with pytest.raises(RuntimeError, match="init_distributed"):
        mesh_mod.make_mesh((1,), ("data",), device="cpu")
    with pytest.raises(ValueError, match="differ"):
        mesh_mod.make_mesh((1, 1), ("data",), device="cpu")
    assert mesh_mod.world_size() == 1
    assert mesh_mod.backend_for("cpu") == "gloo"
    assert mesh_mod.backend_for("cuda:1") == "nccl"
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_serve_steps(_cfg(), mesh={"data": 1})
