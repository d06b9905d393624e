"""The port's roofline layer (``repro_torch.roofline``) against the
reference's (``repro.roofline``), the counterparts of
``tests/test_roofline.py``: the walker's per-op model on the same shapes
as ``jaxpr_cost``, Python loops against scans, the gradient, slice
updates, the ``Roofline`` formulas and ``model_flops_for`` for every
config and shape, the collectives of both routes on a fake group of 8
ranks, and each hand-written kernel's rule, the same through its plain
route (CPU tensors) and its kernel route (``meta`` tensors). Counts are
integers and held exactly unless a line says otherwise.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro.configs import registry as jreg
from repro.configs import shapes as jshapes
from repro.roofline import analysis as janalysis
from repro.roofline import jaxpr_cost
from repro_torch.configs import registry
from repro_torch.configs import shapes
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import decode_attention, flash_attention
from repro_torch.kernels import map_fused, phase1_map, ssm_scan
from repro_torch.launch.mesh import init_fake_group, make_mesh
from repro_torch.roofline import analysis, collectives, hw, walk
from repro_torch.roofline.cost import cost, dot_flops

torch.set_num_threads(1)
F32 = jnp.float32


def sds(*shape):
    return jax.ShapeDtypeStruct(shape, F32)


# --------------------------------------------------------------------------
# the per-op model against jaxpr_cost
# --------------------------------------------------------------------------
@pytest.mark.parametrize("a,b", [((64, 128), (128, 32)),
                                 ((3, 16, 8), (3, 8, 24)),
                                 ((5, 7), (7, 1))])
def test_dot_flops_exact(a, b):
    """2 batch m n k, as the reference's ``_dot_flops`` counts the same
    product; bytes are inputs plus output in both."""
    ref = jaxpr_cost.jaxpr_cost(lambda x, y: x @ y, sds(*a), sds(*b))
    got = cost(lambda x, y: x @ y, torch.empty(a), torch.empty(b))
    assert got["matmul_flops"] == ref["matmul_flops"] == dot_flops(a, b)
    assert got["flops"] == ref["flops"]
    assert got["bytes"] == ref["bytes"]


def test_python_loop_equals_scan():
    """A loop of 16 matmuls counts what the reference's scan of 16 does;
    the reference adds the scan's final carry (4 x 8 float32) once to its
    bytes."""
    def ref_f(ws, x):
        return jax.lax.scan(lambda h, w: (h @ w, None), x, ws)[0]

    def port_f(ws, x):
        for w in ws:
            x = x @ w
        return x

    ref = jaxpr_cost.jaxpr_cost(ref_f, sds(16, 8, 8), sds(4, 8))
    got = cost(port_f, torch.empty(16, 8, 8), torch.empty(4, 8))
    assert got["matmul_flops"] == ref["matmul_flops"] == 16 * 2 * 4 * 8 * 8
    assert got["flops"] == ref["flops"]
    assert got["bytes"] == ref["bytes"] - 4 * 8 * 4


def test_nested_loops():
    def ref_f(ws, x):
        def outer(h, wg):
            return jax.lax.scan(lambda h2, w: (h2 @ w, None), h, wg)[0], None
        return jax.lax.scan(outer, x, ws)[0]

    def port_f(ws, x):
        for wg in ws:
            for w in wg:
                x = x @ w
        return x

    ref = jaxpr_cost.jaxpr_cost(ref_f, sds(3, 5, 8, 8), sds(4, 8))
    got = cost(port_f, torch.empty(3, 5, 8, 8), torch.empty(4, 8))
    assert got["matmul_flops"] == ref["matmul_flops"] == 15 * 2 * 4 * 8 * 8


def test_gradient_counted():
    """The backward's two products are counted, as in ``jax.grad``."""
    def jloss(a, b):
        return jnp.sum((a @ b) ** 2)

    def tloss(a, b):
        return ((a @ b) ** 2).sum()

    ref = jaxpr_cost.jaxpr_cost(lambda a, b: jax.grad(jloss)(a, b),
                                sds(32, 64), sds(64, 16))
    a = torch.empty(32, 64, requires_grad=True)
    b = torch.empty(64, 16, requires_grad=True)
    fwd = cost(tloss, a, b)
    got = cost(lambda a, b: torch.autograd.grad(tloss(a, b), a), a, b)
    assert got["matmul_flops"] == ref["matmul_flops"] \
        == 2 * fwd["matmul_flops"]


def test_slice_update_counts_the_touched_region():
    """A row written into a 1024 x 1024 cache moves twice the row's bytes,
    as the reference's dynamic_update_slice, not the cache's."""
    ref = jaxpr_cost.jaxpr_cost(
        lambda c, u: jax.lax.dynamic_update_slice(c, u, (5, 0)),
        sds(1024, 1024), sds(1, 1024))

    def upd(c, u):
        c[5:6].copy_(u)
        return c

    got = cost(upd, torch.zeros(1024, 1024), torch.ones(1, 1024))
    assert got["bytes"] == ref["bytes"] == 2 * 1024 * 4
    idx = cost(lambda c, u: c.index_put_((torch.tensor([5]),), u),
               torch.zeros(1024, 1024), torch.ones(1, 1024))
    assert idx["bytes"] == 2 * 1024 * 4


def test_views_move_nothing():
    """The one deliberate difference: a view counts nothing (the
    reference counts a reshape's output once)."""
    x = torch.empty(8, 16)
    got = cost(lambda t: t.view(16, 8).transpose(0, 1)[2:5].expand(3, 16),
               x)
    assert got["flops"] == got["bytes"] == 0
    assert jaxpr_cost.jaxpr_cost(lambda t: t.reshape(16, 8) * 1.0,
                                 sds(8, 16))["bytes"] == 2 * 8 * 16 * 4


def test_op_counts_and_paths():
    """``op_counts`` counts each loop trip; paths carry the
    ``record_function`` scopes and module names; a host read of a meta
    tensor is a finding with its path."""
    def f(ws, x):
        with torch.autograd.profiler.record_function("blocks"):
            for w in ws:
                x = x @ w
        return x

    counts = walk.op_counts(f, torch.empty(4, 3, 3), torch.empty(2, 3))
    assert counts["aten.mm"] == 4
    seen = []
    with walk.Walker(lambda op: seen.append(op.path)):
        f(torch.empty(2, 3, 3), torch.empty(2, 3))
        torch.nn.Linear(3, 3)(torch.empty(2, 3))
    assert ("blocks",) in seen and ("Linear",) in seen
    w = walk.Walker()
    with pytest.raises(RuntimeError):
        with w, torch.autograd.profiler.record_function("loss"):
            torch.empty(3, device="meta").sum().item()
    assert w.findings[0].op == "aten._local_scalar_dense"
    assert w.findings[0].path == ("loss",)


def test_peak_live_bytes():
    """Storages allocated under the walker count from their op until they
    are freed; views and in-place results add nothing."""
    def f(x):
        a = x * 2                      # 4 KiB
        b = a + 1                      # 4 KiB, a still alive
        b.add_(1)
        del a
        return b.view(-1)[:10] * 3     # 40 B

    got = cost(f, torch.empty(32, 32))
    assert got["peak_bytes"] == 2 * 32 * 32 * 4


# --------------------------------------------------------------------------
# the roofline
# --------------------------------------------------------------------------
def test_roofline_formulas():
    r = analysis.Roofline(arch="x", shape="train_4k", mesh="pod", chips=256,
                          flops_per_device=1e12, bytes_per_device=1e12,
                          coll_bytes_per_device=1e9, model_flops=1e14)
    assert r.t_comp == pytest.approx(1e12 / 989e12, rel=1e-12)
    assert r.t_mem == pytest.approx(1e12 / 3.35e12, rel=1e-12)
    assert r.t_coll == pytest.approx(1e9 / 450e9, rel=1e-12)
    assert r.dominant == "memory" and r.t_mem > r.t_coll > r.t_comp
    assert r.step_time == r.t_mem
    assert r.useful_flops_fraction == pytest.approx(1e14 / (1e12 * 256))
    assert r.mfu == pytest.approx(1e14 / 256 / r.t_mem / 989e12)
    assert 0 < r.mfu < 1
    assert analysis.share(r, 2 * r.t_mem) == pytest.approx(0.5)
    row = r.row()
    assert set(row) == set(janalysis.Roofline(
        arch="x", shape="s", mesh="m", chips=1, flops_per_device=1.0,
        bytes_per_device=1.0, coll_bytes_per_device=1.0,
        model_flops=1.0).row())


def test_kernel_flops_take_their_rate():
    """A kernel's FLOPs enter t_comp at its rule's rate, the rest at the
    bf16 peak."""
    c = {"flops": 3e12, "bytes": 1.0, "collectives": {},
         "by_kernel": {"ssm_scan": {"flops": 1e12, "comp_seconds": 0.01}}}
    r = analysis.from_cost("a", "s", "m", 1, c, 1.0)
    assert r.t_comp == pytest.approx(2e12 / hw.PEAK_FLOPS_BF16 + 0.01)


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_model_flops_for_every_config_and_shape(arch):
    cfg, jcfg = registry.get_config(arch), jreg.get_config(arch)
    assert cfg.active_params() == jcfg.active_params()
    for name in shapes.SHAPES:
        assert analysis.model_flops_for(cfg, shapes.SHAPES[name]) == \
            janalysis.model_flops_for(jcfg, jshapes.SHAPES[name])


def test_train_flops_dwarf_decode_and_moe_is_sparse():
    cfg = registry.get_config("qwen1.5-0.5b")
    tr = analysis.model_flops_for(cfg, shapes.SHAPES["train_4k"])
    de = analysis.model_flops_for(cfg, shapes.SHAPES["decode_32k"])
    assert tr > 1000 * de
    moe = registry.get_config("phi3.5-moe-42b-a6.6b")
    assert moe.active_params() < 0.3 * moe.n_params()


# --------------------------------------------------------------------------
# collectives, both routes, on a fake group of 8
# --------------------------------------------------------------------------
@pytest.fixture
def fake8():
    init_fake_group(8)
    try:
        yield make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    finally:
        dist.destroy_process_group()


def test_collectives_both_routes(fake8):
    mesh = fake8
    f32 = 4

    def step():
        # functional: DTensor gathers and a reduce-scatter
        x = DTensor.from_local(torch.empty(3, 5, device="meta"), mesh,
                               (Shard(0), Shard(0), Replicate()),
                               run_check=False)
        x.full_tensor()                              # (12, 5) gathered
        p = DTensor.from_local(torch.empty(8, 4, device="meta"), mesh,
                               (Replicate(), Replicate(), Partial()),
                               run_check=False)
        p.redistribute(mesh, (Replicate(), Replicate(), Shard(0)))
        # c10d: sharding.all_reduce_mesh over (pod, data), dist.all_gather
        t = torch.empty(10, device="meta")
        sh.all_reduce_mesh(t, mesh, ("pod", "data"))
        parts = [torch.empty_like(t) for _ in range(2)]
        dist.all_gather(parts, t, group=mesh.get_group(2))

    got = collectives.collective_bytes(step)
    assert got["all-gather"] == (6 * 5 + 12 * 5) * f32 + 2 * 10 * f32
    assert got["reduce-scatter"] == 4 * 4 * f32
    assert got["all-reduce"] == 2 * 10 * f32
    assert cost(step)["collectives"] == got


# --------------------------------------------------------------------------
# each kernel's rule: the plain route and the kernel route count the same
# --------------------------------------------------------------------------
def _map_args():
    g = torch.Generator().manual_seed(0)
    B, N, M, S = 3, 17, 4, 4
    args = (torch.rand(B, generator=g), torch.rand(B, M, generator=g),
            torch.rand(M, generator=g), torch.rand(B, M, generator=g) > 0.3,
            torch.rand(S, M, generator=g), torch.rand(B, N, generator=g) * 4,
            torch.rand(B, N, generator=g) > 0.4,
            torch.randint(0, S, (B, N), generator=g, dtype=torch.int32),
            torch.rand(B, N, generator=g) > 0.5)
    return args


def _attn(B=2, Sq=5, Sk=9, H=4, Hkv=2, hd=8, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(1)
    return (torch.randn(B, Sq, H, hd, generator=g).to(dtype),
            torch.randn(B, Sk, Hkv, hd, generator=g).to(dtype),
            torch.randn(B, Sk, Hkv, hd, generator=g).to(dtype))


def _ssd(dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(2)
    B, L, H, P, N = 2, 32, 3, 8, 16
    return (torch.randn(B, L, H, P, generator=g).to(dtype),
            torch.rand(B, L, H, generator=g), -torch.rand(H, generator=g),
            torch.randn(B, L, N, generator=g).to(dtype),
            torch.randn(B, L, N, generator=g).to(dtype))


KINDS = dict(nominator="min_energy_feasible", phase2_key="value",
             drop_rule="stale_hopeless")
M = _map_args()
FULL = torch.full((2,), 9)
CASES = {
    "map_decide": (lambda *a: map_fused.map_decide(*a, **KINDS), M),
    "evict_stats": (map_fused.evict_stats, M[1:2] + M[3:8]),
    "balance_scan": (map_fused.balance_scan,
                     (torch.tensor([[3, 1, 2], [0, 0, 5]]),
                      torch.ones(2, 6, dtype=torch.bool),
                      torch.ones(2, 6, dtype=torch.bool),
                      torch.zeros(2, 6, dtype=torch.int64))),
    "phase1_map": (phase1_map.phase1_map,
                   (M[1], M[4][M[7].long()], M[5], M[2], M[6], M[3])),
    "flash_attention": (lambda q, k, v, kl: flash_attention.flash_attention(
        q, k, v, causal=True, kv_len=kl, q_offset=4), _attn() + (FULL,)),
    "decode_attention": (decode_attention.decode_attention,
                         _attn(Sq=1) + (FULL,)),
    "ssm_scan": (lambda *a: ssm_scan.ssm_scan(*a, chunk=16), _ssd()),
}


def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_rule_same_on_both_routes(name):
    """The walker counts the kernel's rule once, whichever route runs: on
    CPU tensors the plain version (whose own ops go uncounted), on meta
    tensors nothing but empty meta outputs of the kernel's shapes and
    dtypes. On meta inputs ``kv_len`` and the new tasks are not known, so
    those cases give full ``kv_len`` and every task new on the CPU."""
    fn, args = CASES[name]
    cpu_out, _ = walk.walk(fn, *args)
    cpu_cost = cost(fn, *args)
    meta_args = tuple(_meta(a) for a in args)
    meta_out, _ = walk.walk(fn, *meta_args)
    meta_cost = cost(fn, *meta_args)
    assert cpu_cost["by_kernel"][name]["calls"] == 1
    for k in ("flops", "bytes", "matmul_flops"):
        assert cpu_cost[k] == meta_cost[k] == cpu_cost["by_kernel"][name][k]
    assert cpu_cost["flops"] > 0
    outs = [cpu_out] if torch.is_tensor(cpu_out) else list(cpu_out)
    mouts = [meta_out] if torch.is_tensor(meta_out) else list(meta_out)
    assert [(o.shape, o.dtype) for o in outs] == \
        [(o.shape, o.dtype) for o in mouts]
    assert all(o.device.type == "meta" for o in mouts)
    with pytest.raises(ValueError):        # no walker: meta is refused
        fn(*meta_args)


def test_attention_rule_counts_valid_pairs_only():
    """Causal pairs under q_offset and kv_len, read from the data on the
    CPU: the pairs a brute-force mask leaves, 4 hd per pair and head."""
    q, k, v = _attn()
    kl = torch.tensor([9, 6])
    c = flash_attention.flash_attention_cost(q, k, v, causal=True,
                                             kv_len=kl, q_offset=4)
    pairs = sum(1 for b in range(2) for i in range(5) for j in range(9)
                if j < int(kl[b]) and j <= 4 + i)
    assert c["flops"] == c["matmul_flops"] == 4 * pairs * 4 * 8
    assert c["rate"] == hw.PEAK_FLOPS_BF16
    full = flash_attention.flash_attention_cost(q, k, v, causal=False)
    assert full["flops"] == 4 * 2 * 5 * 9 * 4 * 8
    qf = q.float()
    assert flash_attention.flash_attention_cost(
        qf, k.float(), v.float())["rate"] == hw.PEAK_FLOPS_F32


def test_balance_rule_counts_the_new_tasks():
    load0, _, target, home = CASES["balance_scan"][1]
    some = torch.zeros(2, 6, dtype=torch.bool)
    some[0, 2] = some[1, 4] = True
    c = map_fused.balance_scan_cost(load0, some, target, home)
    assert c["flops"] == 2 * 6 + 2 * 3


def test_ssd_rule_passes_follow_the_dtypes():
    """bf16 B and C: C.B^T on the bf16 tensor cores, the rest in two TF32
    passes (chip_smoke's serve-shape bound); float32: three passes where
    both operands are float32."""
    B, H, L, P, N, Q = 8, 80, 1024, 64, 64, 128
    bf, f = torch.bfloat16, torch.float32
    ops, secs, _ = ssm_scan.ssd_products(B, H, L, P, N, Q, bf, bf, bf)
    n = B * H * (L // Q)
    tri = Q * (Q + 1) // 2
    cb, wx, cs = 2 * n * tri * N, 2 * n * tri * P, 2 * n * Q * N * P
    assert ops == cb + wx + 2 * cs
    assert secs == pytest.approx(cb / 989e12 + 2 * (wx + 2 * cs) / 495e12,
                                 rel=1e-12)
    _, secs32, _ = ssm_scan.ssd_products(B, H, L, P, N, Q, bf, f, f)
    assert secs32 == pytest.approx((3 * (cb + cs) + 2 * (wx + cs)) / 495e12,
                                   rel=1e-12)
