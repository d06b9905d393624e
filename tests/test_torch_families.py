"""The port's moe, vlm, audio and ssm families against the JAX package's,
on the CPU.

granite-moe-3b-a800m and phi3.5-moe-42b-a6.6b (moe), internvl2-1b (vlm),
whisper-medium (audio) and xlstm-125m (ssm) at their smoke sizes: the JAX
package initialises the weights, ``interop.model_params_from_arrays``
carries them into the port bit for bit, and the same numpy-seeded tokens,
frames and patches go through both. ``forward`` (hidden states and aux
loss), ``prefill`` (logits and every cache leaf) and three
``decode_step``s are compared, the JAX side on its Pallas kernels in
interpret mode and on its XLA path, the port's on its kernel path (whose
wrappers take their plain versions on the CPU), its plain path and its
chunked plain path. float32 at rtol 1e-4 and atol 1e-3 x max|want|, as in
``tests/test_torch_models.py``; bfloat16 at atol 2e-2 x max|want|.

MoE decode is held against the JAX ``decode_step``, not against
``forward``: at decode the capacity is that of B tokens, so tokens drop
that a full-sequence forward keeps.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import layers as jll
from repro.models import transformer as jtf
from repro.train import steps as jsteps
from repro_torch import interop
from repro_torch.configs import registry as treg
from repro_torch.models import layers as tll
from repro_torch.models import transformer as ttf
from repro_torch.train import make_serve_steps
from test_torch_models import assert_close, bf16_bits, to_numpy_tree

ARCHS = ("granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b", "internvl2-1b",
         "whisper-medium", "xlstm-125m")
B, S, MAX_SEQ, STEPS = 2, 32, 48, 3
N_FRAMES = 40          # audio: encoder frames, at most MAX_SEQ
F32 = dict(dtype="float32", param_dtype="float32")


def jax_cfg(arch, impl="xla", **kw):
    return jreg.get_smoke_config(arch).scaled(
        remat=False, attn_impl=impl, ssm_impl="xla", **kw)


def port_cfg(arch, impl="kernel", **kw):
    return treg.get_smoke_config(arch).scaled(attn_impl=impl, **kw)


def inputs(arch, seed, n_tokens, batch=B):
    """numpy tokens, then frames (audio) or patches (vlm) at 0.1 N(0, 1),
    from one seeded generator."""
    cfg = jreg.get_smoke_config(arch)
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, n_tokens))}
    if cfg.family == "audio":
        out["frames"] = (rng.standard_normal((batch, N_FRAMES, cfg.d_model))
                         * 0.1).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = (rng.standard_normal(
            (batch, cfg.n_patches, cfg.d_model)) * 0.1).astype(np.float32)
    return out


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def jax_params(arch, dtype):
    cfg = jax_cfg(arch, dtype=dtype, param_dtype=dtype)
    return jtf.init(jax.random.PRNGKey(0), cfg)


def port_params(arch, dtype, cfg):
    return interop.model_params_from_arrays(
        cfg, to_numpy_tree(jax_params(arch, dtype)), device="cpu")


def flat(tree, prefix=""):
    """A nested cache as {"a/b": leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@functools.lru_cache(maxsize=None)
def jax_run(arch, impl, dtype="float32"):
    """The reference's forward hidden and aux, prefill logits and cache,
    and the logits of three decode steps (each fed the next seeded
    token)."""
    cfg = jax_cfg(arch, impl, dtype=dtype, param_dtype=dtype)
    params = jax_params(arch, dtype)
    batch = as_jax(inputs(arch, 1, S))
    hidden, aux = jtf.forward(cfg, params, batch)
    h_last, cache = jtf.prefill(cfg, params, batch, MAX_SEQ)
    out = {"forward": hidden, "aux": aux,
           "prefill": jll.unembed_apply(cfg, params["embed"], h_last),
           "cache": flat(cache)}
    for step in range(STEPS):
        nxt = jnp.asarray(inputs(arch, 10 + step, 1)["tokens"])
        out[f"decode{step}"], cache = jtf.decode_step(cfg, params, cache, nxt)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), out)


def port_run(arch, impl, dtype="float32"):
    cfg = port_cfg(arch, impl, dtype=dtype, param_dtype=dtype)
    params = port_params(arch, dtype, cfg)
    batch = as_torch(inputs(arch, 1, S))
    with torch.no_grad():
        hidden, aux = ttf.forward(cfg, params, batch)
        h_last, cache = ttf.prefill(cfg, params, batch, MAX_SEQ)
        out = {"forward": hidden, "aux": aux,
               "prefill": tll.unembed_apply(cfg, params["embed"], h_last),
               "cache": {k: v.clone() for k, v in flat(cache).items()}}
        for step in range(STEPS):
            nxt = torch.as_tensor(inputs(arch, 10 + step, 1)["tokens"])
            out[f"decode{step}"], cache = ttf.decode_step(cfg, params, cache,
                                                          nxt)
    return out


@pytest.mark.parametrize("port_impl", ["kernel", "plain", "plain_chunked"])
@pytest.mark.parametrize("jax_impl", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_path_matches_jax(arch, jax_impl, port_impl):
    want = jax_run(arch, jax_impl)
    got = port_run(arch, port_impl)
    assert sorted(got["cache"]) == sorted(want["cache"])
    for key in want:
        if key == "cache":
            for leaf, w in want["cache"].items():
                assert_close(got["cache"][leaf], w, 1e-3,
                             f"{arch} cache {leaf}")
        elif key == "aux":
            np.testing.assert_allclose(float(got[key]), want[key], rtol=1e-5,
                                       err_msg=f"{arch} aux")
        else:
            assert_close(got[key], want[key], 1e-3, f"{arch} {key}")
    if jreg.get_smoke_config(arch).family == "moe":
        assert want["aux"] > 0


def port_tensor(a):
    """A JAX array as a torch tensor of the same dtype and bits."""
    a = np.asarray(a)
    return bf16_bits(a) if a.dtype.name == "bfloat16" else \
        torch.from_numpy(a.copy())


def layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def attn_block_decode_ref(cfg, lp, x, pos, cache, i):
    """The body of the reference's decode_step for one attention block."""
    from repro.models import moe as jmoe

    h, _, _, _ = jll.attn_decode(cfg, lp["attn"],
                                 jll.norm_apply(cfg, lp["ln1"], x), pos,
                                 cache["k"][i], cache["v"][i], cache["len"])
    x = x + h
    if "xattn" in lp:
        h, _, _, _ = jll.attn_decode(cfg, lp["xattn"],
                                     jll.norm_apply(cfg, lp["lnx"], x), pos,
                                     cache["xk"][i], cache["xv"][i],
                                     cache["xlen"], cross=True)
        x = x + h
    xn = jll.norm_apply(cfg, lp["ln2"], x)
    if cfg.family == "moe":
        return x + jmoe.moe_apply(cfg, lp["moe"], xn)[0]
    return x + jll.mlp_apply(cfg, lp["mlp"], xn)


def bf16_blocks(arch):
    """Every block of the prefill and of one decode step, the port's fed
    the reference's own input bits (and cache): yields (what, got,
    want)."""
    from repro.models import xlstm as jx
    from repro_torch.models import xlstm as tx

    bf = dict(dtype="bfloat16", param_dtype="bfloat16")
    jcfg, tcfg = jax_cfg(arch, **bf), port_cfg(arch, **bf)
    jp = jax_params(arch, "bfloat16")
    tp = port_params(arch, "bfloat16", tcfg)
    batch = as_jax(inputs(arch, 1, S))
    _, cache = jtf.prefill(jcfg, jp, batch, MAX_SEQ)
    tcache = {k: port_tensor(v) for k, v in cache.items()
              if not isinstance(v, dict)}
    xd = jll.embed_apply(jp["embed"], jnp.asarray(inputs(arch, 10, 1)[
        "tokens"]), jnp.bfloat16)
    dpos = cache["len"][:, None]
    tdpos = port_tensor(dpos)
    if jcfg.family == "ssm":
        x, _ = jtf._embed_input(jcfg, jp, batch)
        for i in range(jcfg.n_layers // 2):
            jl, tl = layer(jp["blocks"], i), ttf._layer(tp["blocks"], i)
            for part, japply, tapply, jdec, tdec in (
                    ("mlstm", jx.mlstm_apply, tx.mlstm_apply,
                     jx.mlstm_decode, tx.mlstm_decode),
                    ("slstm", jx.slstm_apply, tx.slstm_apply,
                     jx.slstm_decode, tx.slstm_decode)):
                want = japply(jcfg, jl[part], x)
                yield f"{part} {i}", tapply(tcfg, tl[part], bf16_bits(x)), \
                    want
                x = want
                st = layer(cache[part], i)
                dwant, _ = jdec(jcfg, jl[part], xd, st)
                dgot, _ = tdec(tcfg, tl[part], bf16_bits(xd),
                               {k: port_tensor(v) for k, v in st.items()})
                yield f"{part} decode {i}", dgot, dwant
                xd = dwant
        return
    enc = tenc = None
    if jcfg.family == "audio":
        x = batch["frames"].astype(jnp.bfloat16)
        pos = jnp.arange(x.shape[1])
        for i in range(jcfg.encoder_layers):
            want, _ = jtf._attn_block_apply(jcfg, layer(jp["enc_blocks"], i),
                                            x, pos, causal=False)
            got, _ = ttf._attn_block_apply(
                tcfg, ttf._layer(tp["enc_blocks"], i), bf16_bits(x),
                torch.arange(x.shape[1]), causal=False)
            yield f"encoder {i}", got, want
            x = want
        enc = jll.norm_apply(jcfg, jp["enc_norm"], x)
        tenc = bf16_bits(enc)
        x = jll.embed_apply(jp["embed"], batch["tokens"], jnp.bfloat16)
    else:
        x, _ = jtf._embed_input(jcfg, jp, batch)
        got, _ = ttf._embed_input(tcfg, tp, as_torch(inputs(arch, 1, S)))
        assert torch.equal(got, bf16_bits(x))
    pos = jnp.arange(x.shape[1])
    epos = None if enc is None else jnp.arange(enc.shape[1])
    for i in range(jcfg.n_layers):
        jl, tl = layer(jp["blocks"], i), ttf._layer(tp["blocks"], i)
        want, _ = jtf._attn_block_apply(jcfg, jl, x, pos, enc=enc,
                                        enc_positions=epos)
        got, _ = ttf._attn_block_apply(
            tcfg, tl, bf16_bits(x), torch.arange(x.shape[1]), enc=tenc,
            enc_positions=None if epos is None else port_tensor(epos))
        yield f"block {i}", got, want
        x = want
        dwant = attn_block_decode_ref(jcfg, jl, xd, dpos, cache, i)
        dgot = ttf._attn_block_decode(
            tcfg, tl, bf16_bits(xd), tdpos,
            {k: v.clone() for k, v in tcache.items()}, i)
        yield f"block decode {i}", dgot, dwant
        xd = dwant


@pytest.mark.parametrize("arch", ARCHS)
def test_families_match_jax_in_bf16(arch):
    """bfloat16 weights and activations, block by block: every block of
    the prefill and of a decode step, fed the reference's own input bits,
    within 2e-2 x max|want|. End to end the two drift further apart
    (rounding happens at other places in the two frameworks, and a
    one-ulp flip grows along the random-weight layers), as
    ``tests/test_torch_models.py`` finds for the hybrid family."""
    n = 0
    for what, got, want in bf16_blocks(arch):
        assert got.dtype == torch.bfloat16, what
        assert_close(got, np.asarray(want, np.float32), 2e-2,
                     f"{arch} bf16 {what}", rtol=0)
        n += 1
    assert n >= 4


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_match_jax(arch):
    """``make_serve_steps`` on the CPU against the reference's, greedy:
    the prefill logits, then three decode steps fed each side's argmax."""
    jcfg = jax_cfg(arch, **F32)
    jpre, jdec = jsteps.make_serve_steps(jcfg)
    tcfg = port_cfg(arch, **F32)
    params = port_params(arch, "float32", tcfg)
    tpre, tdec = make_serve_steps(tcfg, device="cpu")
    batch = inputs(arch, 2, S)
    jlog, jcache = jpre(jax_params(arch, "float32"), as_jax(batch),
                        max_seq=MAX_SEQ)
    tlog, tcache = tpre(params, as_torch(batch), max_seq=MAX_SEQ)
    for step in range(STEPS + 1):
        want = np.asarray(jlog, np.float32)
        assert_close(tlog, want, 1e-3, f"{arch} serve step {step}")
        nxt = want.argmax(-1)
        assert np.array_equal(tlog.numpy().argmax(-1), nxt)
        jlog, jcache = jdec(jax_params(arch, "float32"), jcache,
                            jnp.asarray(nxt))
        tlog, tcache = tdec(params, tcache, torch.as_tensor(nxt))
    prompt = S + jcfg.n_patches if jcfg.family == "vlm" else S
    assert tcache["len"].tolist() == [prompt + STEPS + 1] * B
    if jcfg.family == "audio":
        assert tcache["xlen"].tolist() == [N_FRAMES] * B


@pytest.mark.parametrize("arch", ["internvl2-1b", "whisper-medium",
                                  "xlstm-125m"])
def test_decode_matches_forward(arch):
    """prefill(S-1) + decode(1) == forward(S) at the last position (f32),
    the reference's own check, on the port alone (not for MoE: see the
    module's docstring)."""
    cfg = port_cfg(arch, **F32)
    params = ttf.init(cfg, seed=0, device="cpu")
    batch = as_torch(inputs(arch, 3, 16))
    h, _ = ttf.forward(cfg, params, batch)
    want = tll.unembed_apply(cfg, params["embed"], h[:, -1:]).numpy()
    short = {**batch, "tokens": batch["tokens"][:, :-1]}
    _, cache = ttf.prefill(cfg, params, short, max_seq=MAX_SEQ)
    got, cache2 = ttf.decode_step(cfg, params, cache,
                                  batch["tokens"][:, -1:])
    assert_close(got, want, 1e-3, arch)
    n = 16 + (cfg.n_patches if cfg.family == "vlm" else 0)
    assert cache2["len"].tolist() == [n] * B


def test_audio_frames_must_fit_the_cross_cache():
    arch = "whisper-medium"
    cfg = port_cfg(arch, **F32)
    params = ttf.init(cfg, seed=0, device="cpu")
    batch = as_torch(inputs(arch, 4, 4))
    with pytest.raises(ValueError, match="encoder frames 40"):
        ttf.prefill(cfg, params, batch, max_seq=N_FRAMES - 1)
    _, cache = ttf.prefill(cfg, params, batch, max_seq=N_FRAMES)
    assert cache["xk"].shape[2] == N_FRAMES and cache["len"].tolist() == \
        [4] * B


def test_init_fills_the_xlstm_gate_biases():
    cfg = port_cfg("xlstm-125m", **F32)
    params = ttf.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    b_if = params["blocks"]["mlstm"]["b_if"]
    H = cfg.n_heads
    assert b_if.shape == (cfg.n_layers // 2, 2 * H)
    assert torch.equal(b_if[:, :H], torch.zeros_like(b_if[:, :H]))
    assert torch.equal(b_if[:, H:], torch.full_like(b_if[:, H:], 3.0))
    want = jax_params("xlstm-125m", "float32")["blocks"]["mlstm"]["b_if"]
    assert np.array_equal(b_if.numpy(), np.asarray(want))
