"""The port's training path against the JAX package's, on the CPU: the
chunked LM loss, the loss function and its gradients for one smoke arch
per family, per-block remat, and ``make_train_step``.

The same float32 weights, drawn with numpy, go into both packages (the
port's through ``interop.model_params_from_arrays``), and the same
``SyntheticLM`` batch. The reference
trains on its XLA paths (``attn_impl = ssm_impl = "xla"``), the port on
its plain ones (``TRAIN_IMPLS``). Loss and token count are held within
rel 1e-5; every gradient leaf within rel 1e-4 of the leaf's max|g|; the
losses of three train steps within rel 1e-4.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.datapipe import synthetic as jsyn
from repro.optim import adamw as jadamw
from repro.optim import schedule as jsched
from repro.train import loss as jloss
from repro.train import steps as jsteps
from repro_torch import interop
from repro_torch import tree as tr
from repro_torch.configs import registry as treg
from repro_torch.datapipe.synthetic import SyntheticLM
from repro_torch.models import transformer as ttf
from repro_torch.optim import AdamW, cosine_with_warmup
from repro_torch.train import (
    TRAIN_IMPLS,
    chunked_lm_loss,
    make_grad_step,
    make_loss_fn,
    make_train_step,
)

FAMILY_ARCHS = {"dense": "qwen1.5-0.5b", "hybrid": "zamba2-2.7b",
                "moe": "granite-moe-3b-a800m", "vlm": "internvl2-1b",
                "audio": "whisper-medium", "ssm": "xlstm-125m"}
F32 = dict(dtype="float32", param_dtype="float32")
B, S = 2, 32


def jax_cfg(arch, **kw):
    return jreg.get_smoke_config(arch).scaled(
        remat=False, attn_impl="xla", ssm_impl="xla", **F32, **kw)


def port_cfg(arch, **kw):
    return treg.get_smoke_config(arch).scaled(**TRAIN_IMPLS, **F32, **kw)


@functools.lru_cache(maxsize=None)
def numpy_params(arch):
    """float32 weights drawn with numpy for the parameter tree (the
    reference's init distributions: normal times the leaf's scale, ones,
    zeros); both packages take the same arrays."""
    rng = np.random.default_rng(0)

    def draw(lf):
        if lf.fill == "ones":
            return np.ones(lf.shape, np.float32)
        if lf.fill == "zeros":
            return np.zeros(lf.shape, np.float32)
        if lf.fill == "halves":
            a = np.zeros(lf.shape, np.float32)
            a[..., lf.shape[-1] // 2:] = lf.scale
            return a
        return (rng.standard_normal(lf.shape) * lf.scale).astype(np.float32)
    return ttf.tree_map(draw, ttf.param_spec(port_cfg(arch)))


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    return jax.tree.map(jnp.asarray, numpy_params(arch))


def port_params(arch, cfg=None):
    return interop.model_params_from_arrays(
        cfg or port_cfg(arch), numpy_params(arch), device="cpu")


def batch(arch, step=0, accum=1):
    return SyntheticLM(port_cfg(arch), batch=B, seq=S, seed=3,
                       accum=accum).batch_at(step)


def first(b):
    return {k: v[0] for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(arch):
    cfg = jax_cfg(arch)
    fn = jax.jit(jax.value_and_grad(jloss.make_loss_fn(cfg), has_aux=True))
    (total, metrics), grads = fn(jax_params(arch),
                                 jax.tree.map(jnp.asarray, first(batch(arch))))
    return (float(total), {k: float(v) for k, v in metrics.items()},
            [(jax.tree_util.keystr(p), np.asarray(g)) for p, g in
             jax.tree_util.tree_flatten_with_path(grads)[0]])


def port_loss_and_grads(arch, **kw):
    cfg = port_cfg(arch, **kw)
    params = port_params(arch, cfg)
    live = [p.requires_grad_(True) for p in tr.leaves(params)]
    total, metrics = make_loss_fn(cfg)(
        tr.unflatten_like(params, live),
        {k: torch.as_tensor(v) for k, v in first(batch(arch)).items()})
    grads = torch.autograd.grad(total, live)
    return total, metrics, dict(zip((n for n, _ in tr.named_leaves(params)),
                                    grads))


def rel_close(got, want, rel, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=what)


# --------------------------------------------------------------------------
# The chunked loss alone
# --------------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [512, 7])
@pytest.mark.parametrize("family", list(FAMILY_ARCHS))
def test_chunked_lm_loss_matches_jax(family, chunk):
    """Random hidden states, labels and a mask with holes: the chunk is
    the largest divisor of S not above ``chunk`` (S, and 6 here: four
    chunks)."""
    arch = FAMILY_ARCHS[family]
    jc, tc = jax_cfg(arch), port_cfg(arch)
    rng = np.random.default_rng(5)
    hidden = rng.standard_normal((B, 24, tc.d_model)).astype(np.float32)
    labels = rng.integers(0, tc.vocab_size, (B, 24)).astype(np.int32)
    mask = (rng.random((B, 24)) > 0.2).astype(np.float32)
    want, wcount = jloss.chunked_lm_loss(
        jc, {"embed": jax_params(arch)["embed"]}, jnp.asarray(hidden),
        jnp.asarray(labels), jnp.asarray(mask), chunk=chunk)
    params = port_params(arch, tc)
    got, count = chunked_lm_loss(tc, params, torch.as_tensor(hidden),
                                 torch.as_tensor(labels),
                                 torch.as_tensor(mask), chunk=chunk)
    rel_close(got, want, 1e-5, f"{arch} loss")
    assert float(count) == float(wcount) == float(mask.sum())


# --------------------------------------------------------------------------
# The loss function and its gradients, per family
# --------------------------------------------------------------------------
@pytest.mark.parametrize("family", list(FAMILY_ARCHS))
def test_loss_fn_matches_jax(family):
    arch = FAMILY_ARCHS[family]
    want_total, want, _ = jax_loss_and_grads(arch)
    total, metrics, _ = port_loss_and_grads(arch)
    rel_close(total, want_total, 1e-5, f"{arch}: total")
    rel_close(metrics["loss"], want["loss"], 1e-5, f"{arch}: loss")
    rel_close(metrics["aux"], want["aux"], 1e-5, f"{arch}: aux")
    assert float(metrics["tokens"]) == want["tokens"] == B * (S - 1)


@pytest.mark.parametrize("family", list(FAMILY_ARCHS))
def test_grads_match_jax(family):
    arch = FAMILY_ARCHS[family]
    _, _, want = jax_loss_and_grads(arch)
    _, _, got = port_loss_and_grads(arch)
    assert [n for n, _ in want] == list(got)
    for name, g in want:
        rel_close(got[name], g, 1e-4, f"{arch}: grad {name}")


@pytest.mark.parametrize("family", list(FAMILY_ARCHS))
def test_remat_gives_the_same_grads_bit_for_bit(family):
    arch = FAMILY_ARCHS[family]
    l0, _, g0 = port_loss_and_grads(arch, remat=False)
    l1, _, g1 = port_loss_and_grads(arch, remat=True)
    assert torch.equal(l0, l1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), f"{arch}: {name}"


def test_remat_recomputes_each_block():
    """Under remat the blocks' activations are not held for the backward
    pass: fewer tensors saved by autograd."""
    def saved(remat):
        cfg = port_cfg("qwen1.5-0.5b", remat=remat, n_layers=4)
        params = ttf.init(cfg, seed=0, device="cpu")
        for p in tr.leaves(params):
            p.requires_grad_(True)
        count = [0]

        def pack(t):
            count[0] += 1
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            ttf.forward(cfg, params, {"tokens": torch.as_tensor(
                first(batch("qwen1.5-0.5b"))["tokens"])})
        return count[0]
    assert saved(True) < saved(False) / 4


# --------------------------------------------------------------------------
# make_train_step
# --------------------------------------------------------------------------
def test_train_steps_match_jax():
    """Three steps with accum 2 under a warmup schedule, from the
    reference's parameters and AdamW state (``opt_state_from_arrays``):
    losses and grad norms within rel 1e-4, tokens equal. (The parameters
    are not compared: Adam divides by sqrt(v), so where a gradient is
    near zero its sign, and the step's direction, follow rounding.)"""
    arch = "qwen1.5-0.5b"
    jc, tc = jax_cfg(arch), port_cfg(arch)
    jopt = jadamw.AdamW(lr=None)
    jstep = jsteps.make_train_step(
        jc, jopt, lr_schedule=jsched.cosine_with_warmup(3e-3, 2, 3),
        donate=False)
    jp = jax_params(arch)
    js = jopt.init(jp)
    params = port_params(arch, tc)
    state = interop.opt_state_from_arrays(
        tc, jax.tree.map(np.asarray, js), device="cpu")
    tstep = make_train_step(tc, AdamW(lr=None),
                            lr_schedule=cosine_with_warmup(3e-3, 2, 3),
                            device="cpu")
    data = jsyn.SyntheticLM(jc, batch=4, seq=S, seed=1, accum=2)
    for step in range(3):
        b = data.batch_at(step)
        jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, b))
        params, state, tm = tstep(params, state, b)
        rel_close(tm["loss"], jm["loss"], 1e-4, f"step {step}: loss")
        rel_close(tm["grad_norm"], jm["grad_norm"], 1e-4,
                  f"step {step}: grad norm")
        assert float(tm["tokens"]) == float(jm["tokens"]) == 4 * (S - 1)
        assert int(state.step) == int(js.step) == step + 1


def test_grad_step_averages_microbatches():
    """accum 2 gives the mean of the two microbatches' gradients, and
    the train step's loss is the mean of their losses."""
    arch = "granite-moe-3b-a800m"
    cfg = port_cfg(arch)
    params = port_params(arch, cfg)
    b = batch(arch, accum=2)
    grads, m = make_grad_step(cfg, device="cpu")(params, b)
    halves = [make_grad_step(cfg, device="cpu")(
        params, {k: v[a:a + 1] for k, v in b.items()}) for a in range(2)]
    rel_close(m["loss"], (float(halves[0][1]["loss"])
                          + float(halves[1][1]["loss"])) / 2, 1e-6, "loss")
    assert float(m["tokens"]) == 2 * (B // 2) * (S - 1)
    for g, g0, g1 in zip(tr.leaves(grads), tr.leaves(halves[0][0]),
                         tr.leaves(halves[1][0])):
        assert g.dtype == torch.float32
        rel_close(g, ((g0 + g1) / 2).numpy(), 1e-6, "grad")


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_donate_updates_in_place_with_the_same_values(param_dtype):
    cfg = treg.get_smoke_config("qwen1.5-0.5b").scaled(
        **TRAIN_IMPLS, dtype=param_dtype, param_dtype=param_dtype)
    opt = AdamW(lr=1e-2)
    b = SyntheticLM(cfg, batch=4, seq=16, accum=2).batch_at(0)
    params = ttf.init(cfg, seed=0, device="cpu")
    state = opt.init(params)
    before = [t.clone() for t in tr.leaves((params, state))]
    want_p, want_s, want_m = make_train_step(
        cfg, opt, donate=False, device="cpu")(params, state, b)
    for t, t0 in zip(tr.leaves((params, state)), before):
        assert torch.equal(t, t0)       # donate=False touched nothing
    got_p, got_s, got_m = make_train_step(cfg, opt, device="cpu")(
        params, state, b)
    assert got_p is params and got_s is state
    assert torch.equal(got_m["loss"], want_m["loss"])
    for a, w in zip(tr.leaves((got_p, got_s)), tr.leaves((want_p, want_s))):
        assert a.dtype == w.dtype and torch.equal(a, w)
