"""The port's xLSTM blocks (``repro_torch/models/xlstm.py``) against the
JAX package's on the CPU, float32, on the same numpy inputs.

``gla_chunked`` against the JAX ``gla_chunked`` and the port's sequential
``gla_ref``; its final state continued token by token equals the chunked
form over the longer sequence; the mLSTM and sLSTM blocks and their
decode steps against the reference's, and a prefill continued by decode
steps against a longer prefill.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import xlstm as jx
from repro_torch.configs import registry as treg
from repro_torch.models import xlstm as tx
from test_torch_families import port_tensor

ARCH = "xlstm-125m"
F32 = dict(dtype="float32", param_dtype="float32")


def close(got, want, what, rel=1e-3):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=what)


def gla_inputs(seed, B=2, L=64, H=2, Dk=8, Dv=16):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((B, L, H, Dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, L, H, Dv)).astype(np.float32)
    i_gate = 1 / (1 + np.exp(-rng.standard_normal((B, L, H))))
    logf = -np.log1p(np.exp(-rng.standard_normal((B, L, H)) - 2))
    return q, k, v, i_gate.astype(np.float32), logf.astype(np.float32)


@pytest.mark.parametrize("L,chunk", [(64, 16), (64, 64), (48, 128)])
def test_gla_chunked_matches_jax_and_the_oracle(L, chunk):
    args = gla_inputs(0, L=L)
    want_y, (want_S, want_n) = jx.gla_chunked(
        *map(jnp.asarray, args), min(chunk, L))
    targs = [torch.from_numpy(a) for a in args]
    y, (S, n) = tx.gla_chunked(*targs, chunk)
    close(y, want_y, "y")
    close(S, want_S, "S")
    close(n, want_n, "n")
    ry, (rS, rn) = tx.gla_ref(*targs)
    close(y, ry.numpy(), "y against gla_ref")
    close(S, rS.numpy(), "S against gla_ref")
    close(n, rn.numpy(), "n against gla_ref")


def test_gla_chunked_state_continues_to_a_longer_sequence():
    """The chunked form's final state after 48 tokens, carried through
    the recurrence over 16 more, gives the outputs and state of the
    chunked form over all 64."""
    targs = [torch.from_numpy(a) for a in gla_inputs(1, L=64)]
    want_y, (want_S, want_n) = tx.gla_chunked(*targs, 16)
    _, (S, n) = tx.gla_chunked(*(a[:, :48] for a in targs), 16)
    Dk = targs[0].shape[-1]
    for t in range(48, 64):
        qt, kt, vt, it, ft = (a[:, t] for a in targs)
        f = torch.exp(ft)
        S = f[..., None, None] * S + it[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])
        n = f[..., None] * n + it[..., None] * kt
        qs = qt * Dk ** -0.5
        y = torch.einsum("bhd,bhdv->bhv", qs, S) / torch.einsum(
            "bhd,bhd->bh", qs, n).abs().clamp_min(1.0)[..., None]
        close(y, want_y[:, t].numpy(), f"token {t}")
    close(S, want_S.numpy(), "S")
    close(n, want_n.numpy(), "n")


def test_gla_chunked_raises_off_the_chunk():
    targs = [torch.from_numpy(a) for a in gla_inputs(2, L=40)]
    with pytest.raises(ValueError, match="not a multiple of the chunk 16"):
        tx.gla_chunked(*targs, 16)


def block_params(seed=0):
    jcfg = jreg.get_smoke_config(ARCH).scaled(**F32)
    tcfg = treg.get_smoke_config(ARCH).scaled(**F32)
    key = jax.random.PRNGKey(seed)
    jp = {"mlstm": jx.mlstm_init(jax.random.fold_in(key, 0), jcfg),
          "slstm": jx.slstm_init(jax.random.fold_in(key, 1), jcfg)}
    return jcfg, tcfg, jp, jax.tree.map(port_tensor, jp)


def to_torch(tree):
    return {k: port_tensor(v) for k, v in tree.items()}


@pytest.mark.parametrize("part", ["mlstm", "slstm"])
def test_block_and_decode_match_jax(part):
    """The block over 32 tokens (output and state), then three decode
    steps from that state, against the reference's."""
    jcfg, tcfg, jp, tp = block_params()
    apply_j = getattr(jx, f"{part}_apply")
    apply_t = getattr(tx, f"{part}_apply")
    dec_j, dec_t = getattr(jx, f"{part}_decode"), getattr(tx, f"{part}_decode")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    want, jst = apply_j(jcfg, jp[part], jnp.asarray(x), return_state=True)
    with torch.no_grad():
        got, tst = apply_t(tcfg, tp[part], torch.from_numpy(x),
                           return_state=True)
    close(got, want, f"{part} apply")
    assert sorted(tst) == sorted(jst)
    for k in jst:
        close(tst[k], jst[k], f"{part} state {k}")
    tst = to_torch(jst)           # decode from the reference's own state
    for step in range(3):
        xd = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        want, jst = dec_j(jcfg, jp[part], jnp.asarray(xd), jst)
        with torch.no_grad():
            got, tst = dec_t(tcfg, tp[part], torch.from_numpy(xd), tst)
        close(got, want, f"{part} decode {step}")
        for k in jst:
            close(tst[k], jst[k], f"{part} decode {step} state {k}")


@pytest.mark.parametrize("part", ["mlstm", "slstm"])
def test_prefill_then_decode_equals_a_longer_prefill(part):
    """The port alone: the block over 24 tokens and then 8 decode steps
    gives the block's outputs over all 32 tokens."""
    _, tcfg, _, tp = block_params(1)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 32, tcfg.d_model)).astype(np.float32))
    apply_t = getattr(tx, f"{part}_apply")
    dec_t = getattr(tx, f"{part}_decode")
    with torch.no_grad():
        want = apply_t(tcfg, tp[part], x)
        _, st = apply_t(tcfg, tp[part], x[:, :24], return_state=True)
        for t in range(24, 32):
            got, st = dec_t(tcfg, tp[part], x[:, t:t + 1], st)
            close(got[:, 0], want[:, t].numpy(), f"{part} token {t}")


def test_slstm_starts_from_a_very_negative_stabilizer():
    _, tcfg, _, tp = block_params()
    x = torch.zeros((1, 1, tcfg.d_model))
    _, st = tx.slstm_apply(tcfg, tp["slstm"], x, return_state=True)
    # one step from m = -1e9: m becomes the input gate's pre-activation
    assert st["m"].abs().max() < 1e3
