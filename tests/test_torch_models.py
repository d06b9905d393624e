"""The port's serving path against the JAX package's, on the CPU.

qwen1.5-0.5b (dense) and zamba2-2.7b (hybrid) at their smoke sizes: the
JAX package initialises the weights, ``interop.model_params_from_arrays``
carries them into the port bit for bit, and the same numpy-seeded tokens
go through both. ``forward``, ``prefill`` (logits and every cache leaf)
and three ``decode_step``s are compared, with the JAX side on its Pallas
kernels in interpret mode and on its default XLA path, and the port's on
its kernel path (whose wrappers take their plain versions on the CPU) and
on its plain path. float32 at rtol 1e-4 and atol 1e-3 x max|want|, as in
``tests/test_models.py``; one bfloat16 case at atol 2e-2 x max|want|.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import layers as jll
from repro.models import transformer as jtf
from repro.train import steps as jsteps
from repro_torch import interop
from repro_torch.configs import ModelConfig
from repro_torch.configs import registry as treg
from repro_torch.models import layers as tll
from repro_torch.models import transformer as ttf
from repro_torch.train import make_serve_steps

ARCHS = ("qwen1.5-0.5b", "zamba2-2.7b")
# the dense GQA configs: 16/8 heads (g = 2), 24/8 (g = 3), 64/8 (g = 8)
# at full width; at smoke size g = 2, 3 and 2
DENSE_GQA = ("internlm2-1.8b", "phi4-mini-3.8b", "command-r-35b")
SERVED = ARCHS + DENSE_GQA
B, S, MAX_SEQ, STEPS = 2, 32, 40, 3
F32 = dict(dtype="float32", param_dtype="float32")


def jax_cfg(arch, impl="xla", **kw):
    return jreg.get_smoke_config(arch).scaled(
        remat=False, attn_impl=impl, ssm_impl=impl, **kw)


def port_cfg(arch, impl="kernel", **kw):
    return treg.get_smoke_config(arch).scaled(attn_impl=impl, ssm_impl=impl,
                                              **kw)


def tokens(arch, seed, shape):
    vocab = jreg.get_smoke_config(arch).vocab_size
    return np.random.default_rng(seed).integers(0, vocab, shape)


@functools.lru_cache(maxsize=None)
def jax_params(arch, dtype):
    cfg = jax_cfg(arch, dtype=dtype, param_dtype=dtype)
    return jtf.init(jax.random.PRNGKey(0), cfg)


def to_numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def jax_run(arch, impl, dtype="float32"):
    """The reference's forward hidden, prefill logits and cache, and the
    logits of three decode steps (each fed the next seeded token)."""
    cfg = jax_cfg(arch, impl, dtype=dtype, param_dtype=dtype)
    params = jax_params(arch, dtype)
    toks = jnp.asarray(tokens(arch, 1, (B, S)))
    hidden, _ = jtf.forward(cfg, params, {"tokens": toks})
    h_last, cache = jtf.prefill(cfg, params, {"tokens": toks}, MAX_SEQ)
    out = {"forward": hidden,
           "prefill": jll.unembed_apply(cfg, params["embed"], h_last),
           "cache": dict(cache)}
    for step in range(STEPS):
        nxt = jnp.asarray(tokens(arch, 10 + step, (B, 1)))
        out[f"decode{step}"], cache = jtf.decode_step(cfg, params, cache, nxt)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), out)


def port_run(arch, impl, dtype="float32"):
    cfg = port_cfg(arch, impl, dtype=dtype, param_dtype=dtype)
    params = interop.model_params_from_arrays(
        cfg, to_numpy_tree(jax_params(arch, dtype)), device="cpu")
    toks = torch.as_tensor(tokens(arch, 1, (B, S)))
    with torch.no_grad():
        hidden, _ = ttf.forward(cfg, params, {"tokens": toks})
        h_last, cache = ttf.prefill(cfg, params, {"tokens": toks}, MAX_SEQ)
        out = {"forward": hidden,
               "prefill": tll.unembed_apply(cfg, params["embed"], h_last),
               "cache": {k: v.clone() for k, v in cache.items()}}
        for step in range(STEPS):
            nxt = torch.as_tensor(tokens(arch, 10 + step, (B, 1)))
            out[f"decode{step}"], cache = ttf.decode_step(cfg, params, cache,
                                                          nxt)
    return out


def assert_close(got, want, rel_atol, what, rtol=1e-4):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=rel_atol * float(np.abs(want).max()),
        err_msg=what)


@pytest.mark.parametrize("port_impl", ["kernel", "plain"])
@pytest.mark.parametrize("jax_impl", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("arch", SERVED)
def test_serving_path_matches_jax(arch, jax_impl, port_impl):
    want = jax_run(arch, jax_impl)
    got = port_run(arch, port_impl)
    assert sorted(got["cache"]) == sorted(want["cache"])
    for key in want:
        if key == "cache":
            for leaf, w in want["cache"].items():
                assert_close(got["cache"][leaf], w, 1e-3,
                             f"{arch} cache {leaf}")
        else:
            assert_close(got[key], want[key], 1e-3, f"{arch} {key}")


def test_serving_path_matches_jax_in_bf16():
    """bfloat16 weights and activations end to end (dense): rounding
    happens at other places in the two frameworks, so the logits agree
    within 2e-2 x max|want|."""
    arch = "qwen1.5-0.5b"
    want = jax_run(arch, "xla", "bfloat16")
    got = port_run(arch, "kernel", "bfloat16")
    for key in ("prefill", "decode0", "decode1", "decode2"):
        assert_close(got[key], want[key], 2e-2, f"{arch} bf16 {key}",
                     rtol=0)


def bf16_bits(a):
    """A JAX bfloat16 array as the same bits in a torch tensor."""
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
        torch.bfloat16)


def test_hybrid_blocks_match_jax_in_bf16():
    """bfloat16, hybrid: every block of the prefill and of a decode step,
    fed the reference's own input bits, within 2e-2 x max|want|. End to
    end the two drift further apart: a one-ulp flip in the first Mamba
    block grows some fifty-fold over the smoke model's six random-weight
    layers (the reference's own Pallas and XLA paths differ by 1.6 % of
    max|logits| there), so the blocks are compared one by one."""
    from repro.models import ssm as jssm
    from repro_torch.models import ssm as tssm

    arch = "zamba2-2.7b"
    jcfg = jax_cfg(arch, dtype="bfloat16", param_dtype="bfloat16")
    tcfg = port_cfg(arch, dtype="bfloat16", param_dtype="bfloat16")
    jp = jax_params(arch, "bfloat16")
    tp = interop.model_params_from_arrays(tcfg, to_numpy_tree(jp),
                                          device="cpu")
    pos = jnp.arange(S)
    x = jll.embed_apply(jp["embed"], jnp.asarray(tokens(arch, 1, (B, S))),
                        jnp.bfloat16)
    h_last, cache = jtf.prefill(jcfg, jp, {"tokens": jnp.asarray(
        tokens(arch, 1, (B, S)))}, MAX_SEQ)
    xd = jll.embed_apply(jp["embed"], jnp.asarray(tokens(arch, 10, (B, 1))),
                         jnp.bfloat16)
    dpos = cache["len"][:, None]
    for i in range(jcfg.n_layers):
        jl = jax.tree.map(lambda a, i=i: a[i], jp["blocks"])
        tl = ttf._layer(tp["blocks"], i)
        want = x + jssm.mamba_apply(jcfg, jl["mamba"],
                                    jll.norm_apply(jcfg, jl["ln"], x))
        got = ttf._mamba_layer(tcfg, tl, bf16_bits(x))
        assert_close(got, np.asarray(want, np.float32), 2e-2,
                     f"mamba {i}", rtol=0)
        x = want
        st = {"ssm": cache["ssm"][i], "conv": cache["conv"][i]}
        dwant, _ = jssm.mamba_decode(jcfg, jl["mamba"],
                                     jll.norm_apply(jcfg, jl["ln"], xd), st)
        dgot, _ = tssm.mamba_decode(
            tcfg, tl["mamba"], tll.norm_apply(tcfg, tl["ln"], bf16_bits(xd)),
            {"ssm": torch.from_numpy(np.asarray(st["ssm"]).copy()),
             "conv": bf16_bits(st["conv"])})
        assert_close(dgot, np.asarray(dwant, np.float32), 2e-2,
                     f"mamba decode {i}", rtol=0)
        xd = xd + dwant
        if (i + 1) % jcfg.attn_every:
            continue
        g = i // jcfg.attn_every
        xn = x * jp["inv_norms"][g][None, None].astype(x.dtype)
        want, _ = jtf._attn_block_apply(jcfg, jp["shared_attn"], xn, pos)
        got, _ = ttf._attn_block_apply(tcfg, tp["shared_attn"],
                                       bf16_bits(xn), torch.arange(S))
        assert_close(got, np.asarray(want, np.float32), 2e-2, f"attn {g}",
                     rtol=0)
        x = want
        sp, tsp = jp["shared_attn"], tp["shared_attn"]
        xn = xd * jp["inv_norms"][g][None, None].astype(xd.dtype)
        dwant, _, _, _ = jll.attn_decode(
            jcfg, sp["attn"], jll.norm_apply(jcfg, sp["ln1"], xn), dpos,
            cache["k"][g], cache["v"][g], cache["len"])
        dgot, _, _, _ = tll.attn_decode(
            tcfg, tsp["attn"], tll.norm_apply(tcfg, tsp["ln1"],
                                              bf16_bits(xn)),
            torch.as_tensor(np.array(dpos)), bf16_bits(cache["k"][g]),
            bf16_bits(cache["v"][g]), torch.as_tensor(np.array(
                cache["len"])))
        assert_close(dgot, np.asarray(dwant, np.float32), 2e-2,
                     f"attn decode {g}", rtol=0)
        xd = xn + dwant


@pytest.mark.parametrize("arch", SERVED)
def test_serve_steps_match_jax(arch):
    """``make_serve_steps`` on the CPU against the reference's, greedy:
    the prefill logits, then three decode steps fed each side's argmax."""
    jcfg = jax_cfg(arch, **F32)
    jpre, jdec = jsteps.make_serve_steps(jcfg)
    tcfg = port_cfg(arch, **F32)
    params = interop.model_params_from_arrays(
        tcfg, to_numpy_tree(jax_params(arch, "float32")), device="cpu")
    tpre, tdec = make_serve_steps(tcfg, device="cpu")
    toks = tokens(arch, 2, (B, S))
    jlog, jcache = jpre(jax_params(arch, "float32"),
                        {"tokens": jnp.asarray(toks)}, max_seq=MAX_SEQ)
    tlog, tcache = tpre(params, {"tokens": torch.as_tensor(toks)},
                        max_seq=MAX_SEQ)
    for step in range(STEPS + 1):
        want = np.asarray(jlog, np.float32)
        assert_close(tlog, want, 1e-3, f"{arch} serve step {step}")
        nxt = want.argmax(-1)
        assert np.array_equal(tlog.numpy().argmax(-1), nxt)
        jlog, jcache = jdec(jax_params(arch, "float32"), jcache,
                            jnp.asarray(nxt))
        tlog, tcache = tdec(params, tcache, torch.as_tensor(nxt))
    assert tcache["len"].tolist() == [S + STEPS + 1] * B


@pytest.mark.parametrize("arch", SERVED)
def test_decode_matches_forward(arch):
    """prefill(S-1) + decode(1) == forward(S) at the last position (f32),
    the reference's own check, on the port alone."""
    cfg = port_cfg(arch, **F32)
    params = ttf.init(cfg, seed=0, device="cpu")
    toks = torch.as_tensor(tokens(arch, 3, (B, 16)))
    h, _ = ttf.forward(cfg, params, {"tokens": toks})
    want = tll.unembed_apply(cfg, params["embed"], h[:, -1:]).numpy()
    _, cache = ttf.prefill(cfg, params, {"tokens": toks[:, :-1]}, max_seq=20)
    got, cache2 = ttf.decode_step(cfg, params, cache, toks[:, -1:])
    assert_close(got, want, 1e-3, arch)
    assert cache2["len"].tolist() == [16] * B


def test_cache_write_past_capacity_is_a_no_op():
    cfg = port_cfg("qwen1.5-0.5b", **F32)
    params = ttf.init(cfg, seed=1, device="cpu")
    p = params["blocks"]["attn"]
    p = {k: v[0] for k, v in p.items()}
    x = torch.randn(2, 1, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    ck = torch.randn(2, 4, cfg.n_kv_heads, cfg.hd)
    cv = torch.randn(2, 4, cfg.n_kv_heads, cfg.hd)
    before_k, before_v = ck.clone(), cv.clone()
    cache_len = torch.tensor([4, 2], dtype=torch.int32)
    out, k, v, new_len = tll.attn_decode(cfg, p, x, cache_len[:, None], ck,
                                         cv, cache_len)
    assert k is ck and v is cv and new_len.tolist() == [5, 3]
    assert torch.equal(ck[0], before_k[0]) and torch.equal(cv[0],
                                                           before_v[0])
    assert not torch.equal(ck[1, 2], before_k[1, 2])
    assert torch.equal(ck[1, :2], before_k[1, :2])
    assert torch.isfinite(out).all()


def test_init_follows_the_reference_distributions():
    cfg = port_cfg("zamba2-2.7b", **F32)
    params = ttf.init(cfg, torch.Generator().manual_seed(5), device="cpu")
    m = params["blocks"]["mamba"]
    assert torch.equal(m["A_log"], torch.zeros_like(m["A_log"]))
    assert torch.equal(m["D"], torch.ones_like(m["D"]))
    assert torch.equal(m["dt_bias"], torch.zeros_like(m["dt_bias"]))
    assert torch.equal(params["inv_norms"],
                       torch.ones_like(params["inv_norms"]))
    # normal x fan_in ** -0.5, fan_in the per-layer first dim
    std = float(m["in_proj"].std())
    assert abs(std * cfg.d_model ** 0.5 - 1) < 0.05
    assert abs(float(m["conv_w"].std()) * cfg.ssm_conv ** 0.5 - 1) < 0.1
    again = ttf.init(cfg, torch.Generator().manual_seed(5), device="cpu")
    assert torch.equal(again["embed"]["tok"], params["embed"]["tok"])


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_full_config_matches_the_reference(arch):
    """Same fields, same analytic count, and a parameter tree of the JAX
    package's shapes at full width (nothing allocated on either side)."""
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    assert tcfg.n_params() == jcfg.n_params()
    for prop in ("hd", "padded_vocab", "d_inner", "ssm_heads"):
        assert getattr(tcfg, prop) == getattr(jcfg, prop), prop
    want = jax.tree_util.tree_flatten_with_path(jtf.param_shapes(jcfg))[0]
    spec = ttf.param_spec(tcfg)

    def leaf(path):
        node = spec
        for key in path:
            node = node[key.key]
        return node

    for path, shp in want:
        got = leaf(path)
        assert got.shape == shp.shape, path
        assert str(got.dtype).split(".")[-1] == shp.dtype.name, path
    total = sum(int(np.prod(s.shape)) for _, s in want)
    assert total == sum(int(np.prod(leaf(p).shape)) for p, _ in want)
    if arch == "zamba2-2.7b":
        assert 2.0e9 <= total <= 3.6e9


def test_other_architectures_and_families_wait_for_roadmap():
    """Every id of the registry resolves to the reference's config and
    builds its parameter spec: no family waits any more (the name is
    the one this test had while some did). An unknown id raises
    KeyError, an attention implementation the port lacks ValueError, and
    ``"plain_chunked"`` (the reference's ``"xla_chunked"``) is taken."""
    assert treg.ARCH_IDS == jreg.ARCH_IDS
    moe = treg.get_config("granite-moe-3b-a800m")
    want = jreg.get_config("granite-moe-3b-a800m")
    assert moe.scaled(attn_impl="kernel") == moe
    assert dataclasses.asdict(moe.scaled(attn_impl="plain", ssm_impl="plain")
                              ) == {**dataclasses.asdict(want),
                                    "attn_impl": "plain",
                                    "ssm_impl": "plain"}
    assert set(ttf.FAMILIES) == {treg.get_config(a).family
                                 for a in treg.ARCH_IDS}
    for arch in treg.ARCH_IDS:
        for get in (treg.get_config, treg.get_smoke_config):
            spec = ttf.param_spec(get(arch))
            assert "embed" in spec and "blocks" in spec, arch
    with pytest.raises(ValueError, match="unknown family"):
        ttf.param_spec(port_cfg("qwen1.5-0.5b").scaled(family="rnn"))
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get_config("granite-moe-7b")
    with pytest.raises(ValueError, match="attn_impl"):
        ModelConfig(name="x", family="dense", n_layers=1, d_model=8,
                    n_heads=2, n_kv_heads=2, d_ff=8, vocab_size=8,
                    attn_impl="xla")
    with pytest.raises(ValueError, match="ssm_impl"):
        port_cfg("zamba2-2.7b").scaled(ssm_impl="plain_chunked")
    chunked = port_cfg("qwen1.5-0.5b").scaled(attn_impl="plain_chunked")
    assert chunked.attn_impl == "plain_chunked"


# --------------------------------------------------------------------------
# interop
# --------------------------------------------------------------------------
def leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def bits(a):
    """Raw bits of a numpy array or tensor, as unsigned ints."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else \
            a.view(torch.int32)
        a = a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16 if a.itemsize == 2 else np.uint32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_params_carry_bit_for_bit(arch, dtype):
    tree = to_numpy_tree(jax_params(arch, dtype))
    cfg = port_cfg(arch, dtype=dtype, param_dtype=dtype)
    params = interop.model_params_from_arrays(cfg, tree, device="cpu")
    got = dict(leaves(params))
    want = dict(leaves(tree))
    assert sorted(got) == sorted(want)
    for path, a in want.items():
        if dtype == "bfloat16" and a.dtype == ml_dtypes.bfloat16:
            assert got[path].dtype == torch.bfloat16, path
        assert np.array_equal(bits(got[path]), bits(a)), path


def test_params_reject_missing_extra_and_misshapen_leaves():
    cfg = port_cfg("zamba2-2.7b", **F32)
    tree = to_numpy_tree(jax_params("zamba2-2.7b", "float32"))
    missing = {**tree, "blocks": {**tree["blocks"], "mamba": {
        k: v for k, v in tree["blocks"]["mamba"].items() if k != "D"}}}
    with pytest.raises(KeyError, match=r"missing \['D'\]"):
        interop.model_params_from_arrays(cfg, missing, device="cpu")
    extra = {**tree, "rogue": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match=r"extra \['rogue'\]"):
        interop.model_params_from_arrays(cfg, extra, device="cpu")
    bad = {**tree, "inv_norms": tree["inv_norms"][:1]}
    with pytest.raises(ValueError, match="inv_norms: shape"):
        interop.model_params_from_arrays(cfg, bad, device="cpu")
    with pytest.raises(TypeError, match="float64"):
        interop.model_params_from_arrays(
            cfg, {**tree, "inv_norms": tree["inv_norms"].astype(np.float64)},
            device="cpu")


def test_serve_steps_want_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_serve_steps(port_cfg("zamba2-2.7b"))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ttf.init(port_cfg("zamba2-2.7b"))
