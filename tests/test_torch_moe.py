"""The port's MoE layer (``repro_torch/models/moe.py``) against the JAX
package's ``moe_apply`` on the CPU, float32, on the same numpy inputs and
the JAX package's parameters carried bit for bit.

Beside the smoke configs: a capacity small enough that (token, k) pairs
overflow (the same tokens must drop: a token whose every pair overflows
gets exactly 0 on both sides), ties in the router's probabilities (equal
values go in order of their index, as ``lax.top_k`` orders them), a token
count that is not a multiple of ``moe_group``, and decode's batch of B
tokens with its small capacity.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import moe as jmoe
from repro_torch.configs import registry as treg
from repro_torch.models import moe as tmoe
from test_torch_families import port_tensor

F32 = dict(dtype="float32", param_dtype="float32")


def params(jcfg, seed=0):
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    return jp, {k: port_tensor(v) for k, v in jp.items()}


def run(arch, shape, seed=0, router=None, **kw):
    """(got y, got aux, want y, want aux) for x ~ N(0, 1) of ``shape``."""
    jcfg = jreg.get_smoke_config(arch).scaled(**F32, **kw)
    tcfg = treg.get_smoke_config(arch).scaled(**F32, **kw)
    jp, tp = params(jcfg)
    if router is not None:
        jp = {**jp, "router": jnp.asarray(router)}
        tp = {**tp, "router": torch.from_numpy(router.copy())}
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    want_y, want_aux = jmoe.moe_apply(jcfg, jp, jnp.asarray(x))
    with torch.no_grad():
        got_y, got_aux = tmoe.moe_apply(tcfg, tp, torch.from_numpy(x))
    return (got_y.numpy(), float(got_aux), np.asarray(want_y),
            float(want_aux))


def assert_same(got_y, got_aux, want_y, want_aux, what):
    np.testing.assert_allclose(got_y, want_y, rtol=1e-4,
                               atol=1e-3 * float(np.abs(want_y).max()),
                               err_msg=what)
    np.testing.assert_allclose(got_aux, want_aux, rtol=1e-5, err_msg=what)


@pytest.mark.parametrize("shape", [(2, 32), (8, 1), (3, 17)],
                         ids=["prefill", "decode", "odd"])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "phi3.5-moe-42b-a6.6b"])
def test_moe_apply_matches_jax(arch, shape):
    d = jreg.get_smoke_config(arch).d_model
    assert_same(*run(arch, shape + (d,)), f"{arch} {shape}")


def test_overflowing_pairs_drop_the_same_tokens():
    """capacity_factor 0.25: most pairs overflow; the tokens that lose
    every expert give exactly 0 on both sides, and they are the same."""
    arch = "granite-moe-3b-a800m"
    cfg = treg.get_smoke_config(arch).scaled(capacity_factor=0.25)
    T = 64
    assert tmoe._capacity(T, cfg) < T * cfg.experts_per_token \
        / cfg.n_experts
    got_y, got_aux, want_y, want_aux = run(arch, (2, 32, cfg.d_model),
                                           capacity_factor=0.25)
    assert_same(got_y, got_aux, want_y, want_aux, "overflow")
    dropped = np.all(want_y == 0, axis=-1)
    assert dropped.any() and not dropped.all()
    np.testing.assert_array_equal(np.all(got_y == 0, axis=-1), dropped)


def test_ties_go_in_order_of_index():
    """Uniform router (every probability 1/E): each token picks experts
    0..K-1 in that order; and two equal router columns tie on every
    token, the lower index first."""
    probs = torch.tensor([[0.1, 0.3, 0.2, 0.3, 0.1],
                          [0.25, 0.25, 0.25, 0.25, 0.0]])
    vals, idx = tmoe.top_k(probs, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert idx.tolist() == np.asarray(ji).tolist() == [[1, 3, 2],
                                                       [0, 1, 2]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))

    arch = "granite-moe-3b-a800m"
    cfg = jreg.get_smoke_config(arch)
    d, E = cfg.d_model, cfg.n_experts
    uniform = np.zeros((d, E), np.float32)
    assert_same(*run(arch, (2, 16, d), router=uniform), "uniform router")
    twins = np.random.default_rng(7).standard_normal((d, E)).astype(
        np.float32) * d ** -0.5
    twins[:, 5] = twins[:, 2]
    assert_same(*run(arch, (2, 16, d), router=twins), "twin experts")


def test_group_size_walks_down_to_a_divisor():
    """T = 3 x 17 = 51 tokens with moe_group 24: groups of 17."""
    arch = "phi3.5-moe-42b-a6.6b"
    cfg = treg.get_smoke_config(arch).scaled(moe_group=24)
    assert tmoe._group_size(51, cfg) == 17
    assert tmoe._group_size(64, cfg) == 16
    got = run(arch, (3, 17, cfg.d_model), moe_group=24)
    assert_same(*got, "moe_group 24")


def test_bf16_matches_jax():
    """bfloat16 weights and input: g stays float32 into SiLU on both
    sides; y within 2e-2 x max|want|."""
    arch = "phi3.5-moe-42b-a6.6b"
    bf = dict(dtype="bfloat16", param_dtype="bfloat16")
    jcfg = jreg.get_smoke_config(arch).scaled(**bf)
    tcfg = treg.get_smoke_config(arch).scaled(**bf)
    jp = jmoe.moe_init(jax.random.PRNGKey(0), jcfg)
    tp = {k: port_tensor(v) for k, v in jp.items()}
    x = jnp.asarray(np.random.default_rng(1).standard_normal(
        (2, 32, jcfg.d_model)), jnp.bfloat16)
    want, _ = jmoe.moe_apply(jcfg, jp, x)
    got, _ = tmoe.moe_apply(tcfg, tp, port_tensor(x))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2e-2 * float(np.abs(want).max()))
