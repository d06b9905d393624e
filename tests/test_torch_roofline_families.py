"""The walker's count of whole steps against the reference's
``jaxpr_cost``: one arch per family at its smoke config, the port on its
plain paths (``attn_impl = ssm_impl = "plain"``, the reference's XLA
paths), train step, prefill and decode step, every input on ``meta``.

``matmul_flops`` is held within 1 % of the reference's, after two
differences that are exact and named:

  * the reference's ``dot_general`` s with no contracting dim (outer
    products, which JAX's einsum emits for ``bh,bN,bhp->bhNp`` and for
    the pairwise steps of its three-operand einsums) are broadcast
    multiplies in the port's einsums, not matmuls: they leave the
    reference's count;
  * training: the port's chunked LM loss is checkpointed (its logits are
    recomputed in the backward), the reference keeps them: the
    port adds one LM-head product per microbatch, A 2 mb S d V; and
    zamba2's shared attention block is rematerialized in the port, not
    in the reference: what its backward recomputes, per group and
    microbatch (measured by walking the block with and without remat).

One case stays outside 1 %: xlstm-125m's train step, at 0.953 of the
reference, because the reference's three-operand einsums in the mLSTM
(``bcihd,bcih,bchdv->bcihv`` and its siblings) contract through a
(B, nc, Q, H, Dk, Dv) intermediate whose backward adds products that the
port's two-operand form does not have; the test holds that ratio.

``flops`` and ``bytes`` differ by the per-op model's reach, and are held
within 0.005 of the ratio measured here (all inside 0.5-2 x). The causes:
the port's views count nothing, where the reference counts one FLOP and
the output's bytes for every reshape, slice, squeeze and transpose
(bytes 0.62-0.90 on train and prefill; zamba2's decode FLOPs 0.70, its
conv window and state slices); torch's fused ops (softmax, SiLU) write
one output where XLA's primitives write several; and in decode the
port's plain attention takes the whole bf16 cache to float32 (a copy
the reference's mixed-precision dot does not make), so decode bytes are
1.12-1.94 x.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._pytree import tree_leaves

from repro.configs import registry as jreg
from repro.models import transformer as jtf
from repro.optim.adamw import AdamW as JAdamW
from repro.roofline.jaxpr_cost import _dot_flops, jaxpr_cost
from repro.roofline.jaxpr_walk import walk as jwalk
from repro.train.steps import make_serve_steps as jserve
from repro.train.steps import make_train_step as jtrain
from repro_torch.configs import registry
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import AdamW
from repro_torch.roofline.cost import cost
from repro_torch.train import steps

torch.set_num_threads(1)
A, MB, S = 2, 2, 32
MAX_SEQ = 2 * S
#: (arch, kind): (port / reference FLOPs, port / reference bytes), and the
#: cause per family. Every family's train and prefill bytes are low by
#: the views the reference counts; every decode's bytes high by the plain
#: attention's float32 copy of the bf16 cache.
RATIOS = {
    # dense: decode FLOPs 1.09, the cast cache's elements counted
    ("qwen1.5-0.5b", "train"): (1.0300, 0.7636),
    ("qwen1.5-0.5b", "prefill"): (0.9852, 0.8254),
    ("qwen1.5-0.5b", "decode"): (1.0906, 1.6082),
    # hybrid: the reference counts a FLOP per element of the conv
    # window's and the state's slices and squeezes (decode 0.70)
    ("zamba2-2.7b", "train"): (1.0560, 0.7334),
    ("zamba2-2.7b", "prefill"): (0.9621, 0.7180),
    ("zamba2-2.7b", "decode"): (0.6956, 0.6186),
    # moe: the dispatch's scatter and gather count their regions on both
    # sides; the rest as dense
    ("granite-moe-3b-a800m", "train"): (1.0101, 0.8137),
    ("granite-moe-3b-a800m", "prefill"): (0.9823, 0.8962),
    ("granite-moe-3b-a800m", "decode"): (1.0500, 1.6172),
    # vlm: as dense; the patches' concatenation counted on both sides
    ("internvl2-1b", "train"): (1.0002, 0.7211),
    ("internvl2-1b", "prefill"): (0.9727, 0.7869),
    ("internvl2-1b", "decode"): (0.9789, 1.1221),
    # audio: decode casts the self and the 1500-row cross caches (1.94)
    ("whisper-medium", "train"): (0.9901, 0.7172),
    ("whisper-medium", "prefill"): (0.9748, 0.7600),
    ("whisper-medium", "decode"): (1.1864, 1.9440),
    # ssm: train FLOPs 0.96, the reference's three-operand mLSTM einsums
    ("xlstm-125m", "train"): (0.9590, 0.8850),
    ("xlstm-125m", "prefill"): (0.9724, 0.7131),
    ("xlstm-125m", "decode"): (1.0410, 1.2122),
}
#: matmul FLOPs, port / adjusted reference, where it is not 1 (see above)
MATMUL_RATIO = {("xlstm-125m", "train"): 0.9528}


def outer_flops(fn, *args) -> int:
    """The reference's FLOPs in dot_generals with no contracting dim."""
    acc = [0]

    def visit(eqn, mult, _path):
        if eqn.primitive.name == "dot_general" and \
                not eqn.params["dimension_numbers"][0][0]:
            acc[0] += mult * _dot_flops(eqn)

    jwalk(jax.make_jaxpr(fn)(*args).jaxpr, visit)
    return acc[0]


def batch(cfg, lead, jax_side: bool):
    def mk(shape, dtype):
        if jax_side:
            return jax.ShapeDtypeStruct(shape, getattr(jnp, dtype))
        return torch.empty(shape, dtype=getattr(torch, dtype), device="meta")

    b = {"tokens": mk(lead + (S,), "int32")}
    if cfg.family == "vlm":
        b["patches"] = mk(lead + (cfg.n_patches, cfg.d_model), "bfloat16")
    if cfg.family == "audio":
        b["frames"] = mk(lead + (S, cfg.d_model), "bfloat16")
    return b


def reference(arch, kind):
    cfg = jreg.get_smoke_config(arch)
    p = jtf.param_shapes(cfg)
    if kind == "train":
        fn = jtrain(cfg, JAdamW(), donate=False)
        args = (p, jax.eval_shape(JAdamW().init, p), batch(cfg, (A, MB),
                                                           True))
    elif kind == "prefill":
        pre, _ = jserve(cfg)

        def fn(p, b):
            return pre(p, b, max_seq=MAX_SEQ)
        args = (p, batch(cfg, (MB,), True))
    else:
        _, fn = jserve(cfg)
        args = (p, jax.eval_shape(lambda: jtf.init_cache(cfg, MB, MAX_SEQ)),
                jax.ShapeDtypeStruct((MB, 1), jnp.int32))
    return jaxpr_cost(fn, *args), outer_flops(fn, *args)


def port(arch, kind):
    cfg = registry.get_smoke_config(arch).scaled(**steps.TRAIN_IMPLS)
    p = tf.param_shapes(cfg)
    if kind == "train":
        opt = AdamW()
        fn = steps.make_train_step(cfg, opt, donate=False, device="meta")
        return cost(fn, p, opt.init(p), batch(cfg, (A, MB), False))
    pre, dec = steps.make_serve_steps(cfg, device="meta")
    if kind == "prefill":
        return cost(lambda p, b: pre(p, b, max_seq=MAX_SEQ), p,
                    batch(cfg, (MB,), False))
    return cost(dec, p, tf.init_cache(cfg, MB, MAX_SEQ, device="meta"),
                torch.empty((MB, 1), dtype=torch.int32, device="meta"))


def recompute(cfg) -> int:
    """The matmul FLOPs that rematerializing zamba2's shared attention
    block adds to its forward and backward at (MB, S, d): what the
    backward recomputes of its forward (not all of it: the non-reentrant
    checkpoint stops once the tensors the backward needs are back)."""
    p = tf.param_shapes(cfg)["shared_attn"]
    leaves = [t.requires_grad_(True) for t in tree_leaves(p)]
    x = torch.empty((MB, S, cfg.d_model), dtype=cfg.act_dtype,
                    device="meta", requires_grad=True)
    pos = torch.arange(S, device="meta")

    def step(remat: bool):
        c = cfg.scaled(remat=remat)
        y = tf._remat(c, lambda x, p: tf._attn_block_apply(c, p, x, pos)[0],
                      x, p)
        return torch.autograd.grad(y.float().sum(), [x] + leaves)

    return cost(step, True)["matmul_flops"] - \
        cost(step, False)["matmul_flops"]


def port_extra(arch, kind) -> int:
    """The matmul FLOPs the port's train step recomputes and the
    reference's does not: the LM head per microbatch, and zamba2's shared
    attention block's rematerialization per group and microbatch."""
    if kind != "train":
        return 0
    cfg = registry.get_smoke_config(arch).scaled(**steps.TRAIN_IMPLS)
    extra = A * 2 * MB * S * cfg.d_model * cfg.vocab_size
    if cfg.family == "hybrid":
        extra += A * (cfg.n_layers // cfg.attn_every) * recompute(cfg)
    return extra


@pytest.mark.parametrize("arch,kind", list(RATIOS))
def test_step_cost_against_jaxpr_cost(arch, kind):
    ref, outer = reference(arch, kind)
    got = port(arch, kind)
    want_mm = ref["matmul_flops"] - outer + port_extra(arch, kind)
    assert got["matmul_flops"] / want_mm == pytest.approx(
        MATMUL_RATIO.get((arch, kind), 1.0), abs=0.005 if (
            arch, kind) in MATMUL_RATIO else 0.01)
    flops, nbytes = RATIOS[arch, kind]
    assert got["flops"] / ref["flops"] == pytest.approx(flops, abs=0.005)
    assert got["bytes"] / ref["bytes"] == pytest.approx(nbytes, abs=0.005)
    assert got["findings"] == []
