"""The port's sharding rules against the JAX package's, and the sharded
sweep (``repro_torch.distributed.sharding``, ``run_sweep(shard=True)``).

Spec tables: for all ten configs at full width (shapes only), on the
meshes (2, 2, 2), (16, 16) and (2, 16, 16), the port's specs for
parameters, optimizer state, batches (with and without the microbatch
axis) and decode caches at ``configs/shapes.py``'s decode shapes equal
the reference's ``NamedSharding`` specs after ``_valid``, and turning a
spec into ``DTensor`` placements and back is the identity. The
reference's rules run on ``jax.sharding.AbstractMesh`` es, the port's on
dicts of axis sizes: no device is needed for either.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro import experiments as jexp
from repro import scenarios as jscenarios
from repro.configs import registry as jreg
from repro.configs import shapes as jshapes
from repro.distributed import sharding as jsh
from repro.models import transformer as jtf
from repro_torch import experiments as texp
from repro_torch import tree as tr
from repro_torch.configs import registry as treg
from repro_torch.distributed import sharding as sh
from repro_torch.experiments import sweep as tsweep
from repro_torch.models import transformer as ttf
from repro_torch.optim.adamw import AdamW
from test_torch_common import CPU, assert_metrics_match

torch.set_num_threads(1)

MESHES = {"2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = jreg.ARCH_IDS


def _meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), dict(zip(axes, shape))


def _canon(spec) -> tuple:
    """A reference PartitionSpec as the port writes it: a tuple, one
    entry per dim, a one-axis entry as the name."""
    out = []
    for e in tuple(spec):
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = e[0] if len(e) == 1 else e
        out.append(e)
    return tuple(out)


def _ref_specs(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))
    return {jax.tree_util.keystr(p): _canon(s.spec) for p, s in leaves}


def _port_specs(tree, ndims: dict) -> dict:
    out = {}
    for name, lay in tr.named_leaves(tree):
        assert len(lay.spec) == ndims[name], name
        out[name] = lay.spec
    return out


def _ndims(tree) -> dict:
    return {n: len(x.shape) for n, x in tr.named_leaves(tree)}


def _padded(ref: dict, ndims: dict) -> dict:
    """The reference's specs padded with None to their leaves' ranks (a
    trailing None is the same sharding)."""
    return {n: s + (None,) * (ndims[n] - len(s)) for n, s in ref.items()}


def _assert_round_trip(tree, mesh: dict) -> None:
    for name, lay in tr.named_leaves(tree):
        pl = sh.to_placements(lay.spec, mesh)
        assert len(pl) == len(mesh)
        assert sh.from_placements(pl, mesh, len(lay.spec)) == lay.spec, name


def _cfgs(arch):
    return jreg.get_config(arch), treg.get_config(arch)


# ----------------------------------------------------------- spec tables
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_match_reference(arch, mesh_name):
    jm, tm = _meshes(mesh_name)
    jcfg, tcfg = _cfgs(arch)
    jshapes_ = jtf.param_shapes(jcfg)
    tshapes = ttf.param_shapes(tcfg)
    ndims = _ndims(tshapes)
    got = sh.param_shardings(tshapes, tm, tcfg)
    want = _padded(_ref_specs(jsh.param_shardings(jshapes_, jm, jcfg)),
                   ndims)
    assert _port_specs(got, ndims) == want
    _assert_round_trip(got, tm)

    tgot = sh.opt_state_shardings(tshapes, tm, tcfg)
    ond = _ndims(AdamW().init(tshapes))
    want = _padded(_ref_specs(jsh.opt_state_shardings(jshapes_, jm, jcfg)),
                   ond)
    assert _port_specs(tgot, ond) == want
    assert tgot.step.spec == ()
    _assert_round_trip(tgot, tm)


def test_attention_overrides_are_exercised():
    """internvl2-1b's 14 heads (2 kv) do not divide a TP width of 16:
    its projections fall back to FSDP-only, as the reference's do."""
    _, tm = _meshes("16x16")
    cfg = treg.get_config("internvl2-1b")
    lay = sh.param_shardings(ttf.param_shapes(cfg), tm, cfg)
    attn = lay["blocks"]["attn"]
    assert attn["wq"].spec == (None, "data", None)
    assert attn["wo"].spec == (None, None, "data")
    assert attn["wk"].spec == (None, "data", None)
    qwen = treg.get_config("qwen1.5-0.5b")       # 16 heads: TP kept
    lay = sh.param_shardings(ttf.param_shapes(qwen), tm, qwen)
    assert lay["blocks"]["attn"]["wq"].spec == (None, "data", "model")
    # a vocabulary the model axis does not divide is replicated there
    assert lay["embed"]["tok"].spec == ("model", "data")
    odd = {"embed": {"tok": torch.empty((151_937, 1024), device="meta")}}
    assert sh.param_shardings(odd, tm)["embed"]["tok"].spec == (
        None, "data")


def _batch_shapes(cfg, B, S, A=None):
    lead = (B,) if A is None else (A, B // A)
    shapes = {"tokens": (lead + (S,), np.int32)}
    if cfg.family == "vlm":
        shapes["patches"] = (lead + (cfg.n_patches, cfg.d_model),
                             np.float32)
    if cfg.family == "audio":
        shapes["frames"] = (lead + (S, cfg.d_model), np.float32)
    return ({k: jax.ShapeDtypeStruct(s, d) for k, (s, d) in shapes.items()},
            {k: torch.empty(s, device="meta") for k, (s, _) in
             shapes.items()})


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_match_reference(arch, mesh_name):
    jm, tm = _meshes(mesh_name)
    jcfg, tcfg = _cfgs(arch)
    train = jshapes.SHAPES["train_4k"]
    for A, batch in ((None, train.global_batch), (2, train.global_batch),
                     (None, 3), (4, 8)):
        jb, tb = _batch_shapes(tcfg, batch, 64, A)
        got = sh.batch_sharding(tm, tb, accum_dim=A is not None)
        want = _ref_specs(jsh.batch_sharding(jm, jb, accum_dim=A is not None))
        assert _port_specs(got, _ndims(tb)) == want, (A, batch)
        _assert_round_trip(got, tm)
    assert sh.batch_axes(tm) == jsh.batch_axes(jm)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, mesh_name):
    jm, tm = _meshes(mesh_name)
    jcfg, tcfg = _cfgs(arch)
    n = 0
    for name, shape in jshapes.SHAPES.items():
        ok, _ = jshapes.applicable(jcfg, name)
        if shape.kind != "decode" or not ok:
            continue
        jc = jax.eval_shape(lambda: jtf.init_cache(
            jcfg, shape.global_batch, shape.seq_len))
        tc = ttf.init_cache(tcfg, shape.global_batch, shape.seq_len,
                            device="meta")
        ndims = _ndims(tc)
        got = sh.cache_sharding(tcfg, tm, tc)
        want = _padded(_ref_specs(jsh.cache_sharding(jcfg, jm, jc)), ndims)
        assert _port_specs(got, ndims) == want, name
        _assert_round_trip(got, tm)
        n += 1
    assert n >= 1


def test_placements_order_and_errors():
    from torch.distributed.tensor import Replicate, Shard

    mesh = {"pod": 2, "data": 4, "model": 2}
    assert sh.to_placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert sh.to_placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        sh.to_placements((("data", "pod"),), mesh)
    with pytest.raises(ValueError, match="two dims"):
        sh.to_placements(("data", "data"), mesh)
    lay = sh.Layout(mesh, (("pod", "data"), "model", None))
    assert lay.rows().spec == (("pod", "data"), None, None)


def test_pad_batch_pads_and_preserves():
    """pad_batch repeats row 0 up to the multiple and leaves aligned
    batches untouched."""
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(3, 2),
            "b": torch.arange(3, dtype=torch.int32)}
    padded = sh.pad_batch(tree, 4)
    assert padded["a"].shape == (4, 2) and padded["b"].shape == (4,)
    assert torch.equal(padded["a"][:3], tree["a"])
    assert torch.equal(padded["a"][3], tree["a"][0])
    assert torch.equal(padded["b"], torch.tensor([0, 1, 2, 0],
                                                 dtype=torch.int32))
    assert sh.pad_batch(tree, 3)["a"].shape == (3, 2)


# ----------------------------------------------------------- the sweep
SHARD_SPEC = dict(system="paper_x2", rates=(3.0, 5.0), reps=3, n_tasks=60,
                  heuristics=("ELARE", "FELARE"), seed=2,
                  dispatcher="round_robin", observers=("task_log",))


def _leaves(res) -> list:
    return [np.asarray(x) for x in jax.tree.leaves((
        res.metrics._asdict(), res.aux))]


def test_sweep_devices_single_device_fallback():
    assert sh.sweep_devices(CPU) is None
    assert sh.sweep_devices(CPU, max_devices=4) is None
    if torch.cuda.is_available() and torch.cuda.device_count() == 1:
        assert sh.sweep_devices() is None
    spec = texp.SweepSpec(system="paper_x2", rates=(4.0,), reps=2,
                          n_tasks=50, heuristics=("ELARE",), seed=3,
                          dispatcher="least_queued")
    ref = texp.run_sweep(spec, device=CPU)
    fb = texp.run_sweep(spec, device=CPU, shard=True)
    for a, b in zip(_leaves(ref), _leaves(fb)):
        assert a.tobytes() == b.tobytes()


def test_sharded_sweep_bit_exact_and_matches_reference(monkeypatch):
    """run_sweep(shard=True) over four CPU devices == the unsharded sweep,
    byte for byte, on every metrics and aux leaf; the (2 rates x 3 reps)
    grid does not divide the four devices, so the padding is exercised.
    On the reference's traces it gives the reference's unsharded sweep
    (its sharded one fails on this host's JAX:
    tests/test_distributed.py::test_sharded_sweep_bit_exact_vs_unsharded).
    """
    devices = [torch.device("cpu")] * 4
    seen = []

    def four(device=None, max_devices=None):
        seen.append(device)
        return devices
    spec = texp.SweepSpec(**SHARD_SPEC)
    ref = texp.run_sweep(spec, device=CPU)
    monkeypatch.setattr(sh, "sweep_devices", four)
    got = texp.run_sweep(spec, device=CPU, shard=True)
    assert seen, "the sharded path was not taken"
    a, b = _leaves(ref), _leaves(got)
    assert a and len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.tobytes() == y.tobytes()
    assert got.run_info["ELARE"]["loop_iterations"] > 0

    jspec = jexp.SweepSpec(**SHARD_SPEC)
    jref = jexp.run_sweep(jspec)
    stack = jscenarios.DEFAULT.stack(
        jax.random.PRNGKey(2), (3.0, 5.0), 3, 60,
        jscenarios.get_fleet("paper_x2").build().eet, cv_run=0.1)
    got = texp.run_sweep(spec, traces=[np.asarray(x) for x in stack],
                         device=CPU, shard=True)
    assert_metrics_match(
        {k: np.asarray(v) for k, v in jref.metrics._asdict().items()},
        got.metrics._asdict(), "sharded paper_x2 round_robin",
        n_machines=8)
    for k, v in jref.aux["task_log"].items():
        v, w = np.asarray(v), got.aux["task_log"][k]
        if v.dtype.kind == "f":
            np.testing.assert_allclose(w, v, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(w, v, err_msg=k)


def test_cli_shard_note(capsys, tmp_path):
    argv = ["--device", "cpu", "--rates", "4", "--reps", "2", "--tasks",
            "40", "--heuristics", "ELARE", "--shard", "--out",
            str(tmp_path)]
    tsweep.main(argv)
    out = capsys.readouterr().out
    assert "(--shard: single device, running unsharded)" in out
