"""The port's optimizer, schedules and LM data pipeline against the JAX
package's, on the CPU; and the kernel wrappers' refusal under autograd.

AdamW: the same numpy gradients, parameters and state go through both
``update``s (the reference's op by op, as its own tests call it); every
leaf of the new parameters and moments is held within rel 1e-6 of
max|want| (the global norm's per-leaf sums run in another order) and the
step counter exactly. Schedules within rel 1e-6. ``SyntheticLM`` is pure
numpy in both packages, so its batches are held bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs import shapes as jshapes
from repro.datapipe import synthetic as jsyn
from repro.optim import adamw as jadamw
from repro.optim import schedule as jsched
from repro_torch import tree as tr
from repro_torch.configs import registry as treg
from repro_torch.configs import shapes as tshapes
from repro_torch.datapipe.synthetic import Prefetcher, SyntheticLM, input_specs
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.optim import AdamW, AdamWState, constant, cosine_with_warmup
from repro_torch.train import TRAIN_IMPLS, make_grad_step, make_train_step


def rel_close(got, want, rel, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=what)


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------
def tree_arrays(rng, dtype, grad_scale=1.0):
    """A nested tree whose dict keys are out of sorted order, so the global
    norm's sum order is exercised."""
    def a(*shape):
        return (rng.standard_normal(shape) * grad_scale).astype(np.float32)
    tree = {"w": a(24, 17), "b": {"z": a(9), "a": a(3, 5)}, "c": a(40)}
    if dtype == "bfloat16":
        tree["w"] = np.asarray(jnp.asarray(tree["w"], jnp.bfloat16))
    return tree


def to_torch(tree):
    def leaf(_, x):
        x = np.asarray(x)
        if x.dtype.name == "bfloat16":
            return torch.from_numpy(x.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(x))
    return tr.map_named(leaf, tree)


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


CASES = {
    "float32": dict(dtype="float32", opt={}, scale=0.1),
    "bf16_params_fp32_moments": dict(dtype="bfloat16", opt={}, scale=0.1),
    "clipped": dict(dtype="float32", opt={"clip_norm": 1e-3}, scale=1e3),
    "decay": dict(dtype="float32", opt={"weight_decay": 0.5, "lr": 0.1},
                  scale=0.01),
    "unclipped": dict(dtype="float32", opt={"clip_norm": 1e9}, scale=0.1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_adamw_update_matches_jax(case):
    c = CASES[case]
    rng = np.random.default_rng(0)
    params = tree_arrays(rng, c["dtype"])
    jopt, topt = jadamw.AdamW(**c["opt"]), AdamW(**c["opt"])
    jp, tp = jax.tree.map(jnp.asarray, params), to_torch(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(4):
        g = tree_arrays(rng, "float32", c["scale"])
        jp, js, jn = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tn = topt.update(to_torch(g), ts, tp)
        rel_close(tn, jn, 1e-6, f"{case} step {step}: grad norm")
        assert int(ts.step) == int(js.step) == step + 1
        assert ts.step.dtype == torch.int32
        for what, jt, tt in (("params", jp, tp), ("mu", js.mu, ts.mu),
                             ("nu", js.nu, ts.nu)):
            for (name, want), got in zip(
                    jax.tree_util.tree_flatten_with_path(jt)[0],
                    tr.leaves(tt)):
                assert str(got.dtype).endswith(str(want.dtype)), name
                rel_close(as_f32(got), as_f32(want), 1e-6,
                          f"{case} step {step}: {what}"
                          f"{jax.tree_util.keystr(name)}")


def test_adamw_inplace_equals_functional():
    rng = np.random.default_rng(1)
    params = to_torch(tree_arrays(rng, "bfloat16"))
    grads = to_torch(tree_arrays(rng, "float32", 0.1))
    opt = AdamW(lr=1e-2)
    want_p, want_s, want_n = opt.update(grads, opt.init(params), params)
    state = opt.init(params)
    got_p, got_s, got_n = opt.update(grads, state, params, inplace=True)
    assert got_p is params and got_s is state
    assert torch.equal(got_n, want_n) and int(state.step) == 1
    for a, b in zip(tr.leaves((got_p, got_s)), tr.leaves((want_p, want_s))):
        assert torch.equal(a, b)


def test_adamw_converges_on_quadratic():
    opt = AdamW(lr=0.05, weight_decay=0.0)
    params = {"w": torch.zeros(8)}
    target = torch.linspace(-1, 1, 8)
    state = opt.init(params)
    for _ in range(300):
        params, state, _ = opt.update({"w": params["w"] - target}, state,
                                      params)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=1e-2)


def test_adamw_clip_reports_the_norm_before_clipping():
    opt = AdamW(lr=1.0, clip_norm=1e-3, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    p2, _, gnorm = opt.update({"w": torch.full((4,), 1e6)}, opt.init(params),
                              params)
    assert float(gnorm) > 1e5
    # Adam's first step moves each coordinate by about lr, clip or not
    assert float(p2["w"].abs().max()) <= 1.0 + 1e-6


def test_adamw_bf16_params_fp32_moments_and_lr_required():
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    opt = AdamW(lr=1e-2)
    state = opt.init(params)
    assert state.mu["w"].dtype == torch.float32
    assert isinstance(state, AdamWState)
    p2, _, _ = opt.update({"w": torch.ones(4, dtype=torch.bfloat16)}, state,
                          params)
    assert p2["w"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="lr"):
        AdamW(lr=None).update({"w": torch.ones(4)}, state, params)


def test_leaves_follow_jax_order():
    tree = {"p": {"b": {"z": 1, "a": 2}, "a": 3},
            "o": AdamWState(step=4, mu={"y": 5, "x": 6}, nu={"k": 7})}
    got = list(tr.named_leaves(tree))
    want = jax.tree_util.tree_flatten_with_path(
        {"p": tree["p"], "o": jadamw.AdamWState(*tree["o"])})[0]
    assert [n for n, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    assert [v for _, v in got] == [v for _, v in want]
    assert tr.unflatten_like(tree, [v * 10 for v in tr.leaves(tree)]) == \
        tr.map_named(lambda _, v: v * 10, tree)


# --------------------------------------------------------------------------
# Schedules
# --------------------------------------------------------------------------
@pytest.mark.parametrize("warmup,total,min_frac", [(10, 100, 0.1),
                                                   (0, 50, 0.0),
                                                   (7, 7, 0.3)])
def test_cosine_with_warmup_matches_jax(warmup, total, min_frac):
    steps = np.arange(0, total + 20)
    want = np.asarray([jsched.cosine_with_warmup(1e-3, warmup, total,
                                                 min_frac)(s) for s in steps])
    lr = cosine_with_warmup(1e-3, warmup, total, min_frac)
    got = np.asarray([float(lr(int(s))) for s in steps], np.float32)
    rel_close(got, want, 1e-6, "cosine_with_warmup")
    # the optimizer's int32 counter as the step
    assert float(lr(torch.tensor(5, dtype=torch.int32))) == got[5]
    assert lr(3).dtype == torch.float32


def test_constant_matches_jax():
    got = constant(3e-4)(12345)
    assert got.dtype == torch.float32
    assert float(got) == float(jsched.constant(3e-4)(12345))


# --------------------------------------------------------------------------
# SyntheticLM, Prefetcher, input_specs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_synthetic_lm_bit_for_bit(arch, accum):
    jcfg, tcfg = jreg.get_smoke_config(arch), treg.get_smoke_config(arch)
    for seed, step in ((0, 0), (7, 3)):
        want = jsyn.SyntheticLM(jcfg, batch=4, seq=16, seed=seed,
                                accum=accum).batch_at(step)
        got = SyntheticLM(tcfg, batch=4, seq=16, seed=seed,
                          accum=accum).batch_at(step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, (arch, k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["tokens"].shape == (accum, 4 // accum, 16)
        assert int(got["tokens"].max()) < tcfg.vocab_size


def test_synthetic_lm_stream_and_seeds():
    cfg = treg.get_smoke_config("qwen1.5-0.5b")
    data = SyntheticLM(cfg, batch=2, seq=8, seed=1)
    it = iter(data)
    for step in range(3):
        np.testing.assert_array_equal(next(it)["tokens"],
                                      data.batch_at(step)["tokens"])
    other = SyntheticLM(cfg, batch=2, seq=8, seed=2).batch_at(0)
    assert not np.array_equal(other["tokens"], data.batch_at(0)["tokens"])


def test_prefetcher_order():
    assert list(Prefetcher(iter(range(10)), depth=3)) == list(range(10))
    cfg = treg.get_smoke_config("qwen1.5-0.5b")
    data = SyntheticLM(cfg, batch=2, seq=8)
    got = Prefetcher(data.batch_at(s) for s in range(2, 6))
    for step, b in zip(range(2, 6), got):
        np.testing.assert_array_equal(b["tokens"],
                                      data.batch_at(step)["tokens"])


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_input_specs_match_jax_and_real_batches(arch):
    shape = tshapes.SHAPES["train_4k"]
    want = jsyn.input_specs(jreg.get_config(arch),
                            jshapes.SHAPES["train_4k"], accum=8)
    got = input_specs(treg.get_config(arch), shape, accum=8)
    assert set(got) == set(want)
    for k, spec in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == spec.shape, k
        assert str(got[k].dtype).endswith(str(spec.dtype)), k
    assert got["tokens"].shape[0] * got["tokens"].shape[1] == \
        shape.global_batch
    # the specs of a small batch are the shapes of SyntheticLM's batch
    cfg = treg.get_smoke_config(arch)
    small = tshapes.InputShape("small", 16, 4, "train")
    spec = input_specs(cfg, small, accum=2)
    if cfg.family != "audio":   # the audio specs halve the sequence
        real = SyntheticLM(cfg, batch=4, seq=16, accum=2).batch_at(0)
        assert {k: tuple(v.shape) for k, v in spec.items()} == \
            {k: v.shape for k, v in real.items()}


# --------------------------------------------------------------------------
# The kernel wrappers refuse autograd; training refuses the kernels
# --------------------------------------------------------------------------
def kernel_call(name, grad_arg):
    gen = torch.Generator().manual_seed(0)

    def t(*shape):
        return torch.randn(shape, generator=gen)
    if name == "ssm_scan":
        args = [t(1, 8, 2, 4), torch.rand(1, 8, 2, generator=gen) + 0.1,
                -torch.rand(2, generator=gen), t(1, 8, 4), t(1, 8, 4)]
        fn = lambda *a: ssm_ops.ssm_scan(*a, chunk=4)[0]  # noqa: E731
    elif name == "flash_attention":
        args = [t(1, 8, 2, 16), t(1, 8, 2, 16), t(1, 8, 2, 16)]
        fn = flash_ops.flash_attention
    else:
        args = [t(1, 1, 2, 16), t(1, 8, 2, 16), t(1, 8, 2, 16),
                torch.tensor([5])]
        fn = dec_ops.decode_attention
    args[grad_arg].requires_grad_(True)
    return fn, args


@pytest.mark.parametrize("name,grad_arg", [
    ("flash_attention", 0), ("flash_attention", 2), ("decode_attention", 0),
    ("decode_attention", 1), ("ssm_scan", 0), ("ssm_scan", 3)])
def test_kernel_wrappers_refuse_autograd(name, grad_arg):
    fn, args = kernel_call(name, grad_arg)
    with pytest.raises(RuntimeError, match="no backward.*plain"):
        fn(*args)
    with torch.no_grad():           # serving: the plain version on the CPU
        out = fn(*args)
    assert torch.isfinite(out).all() and not out.requires_grad
    args[grad_arg] = args[grad_arg].detach()
    assert torch.isfinite(fn(*args)).all()


@pytest.mark.parametrize("impl", [{"attn_impl": "kernel"},
                                  {"ssm_impl": "kernel"}])
def test_training_refuses_the_kernel_paths(impl):
    cfg = treg.get_smoke_config("zamba2-2.7b").scaled(**{**TRAIN_IMPLS,
                                                         **impl})
    with pytest.raises(ValueError, match="no backward"):
        make_train_step(cfg, AdamW(), device="cpu")
    with pytest.raises(ValueError, match="no backward"):
        make_grad_step(cfg, device="cpu")


def test_train_step_wants_one_device():
    """Without a mesh the step wants its one device (the card unless the
    CPU is asked for); a mesh must be a DeviceMesh (the sharded step's
    tests are in tests/test_torch_distributed.py)."""
    cfg = treg.get_smoke_config("qwen1.5-0.5b").scaled(**TRAIN_IMPLS)
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_train_step(cfg, AdamW(), mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            make_train_step(cfg, AdamW())
