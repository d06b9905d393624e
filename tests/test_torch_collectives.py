"""The port's collectives on 4 gloo ranks against the JAX package: ring
attention, the GPipe schedule (forward and gradients) and the int8
error-feedback compression (``repro_torch.distributed``).

One spawned group of 4 ranks runs every check (``rank_collectives``);
the reference runs once in a subprocess on 4 placeholder CPU devices, as
its own tests do. This module imports neither JAX nor the shared helpers
at its top: each rank imports it to find its function.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.distributed import compression as comp
from repro_torch.distributed.pipeline import gpipe, stack_stages
from repro_torch.distributed.ring_attention import ring_attention
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.layers import sdpa_plain

WORLD = 4
# tests/test_ring_attention.py's and tests/test_pipeline.py's shapes
RING = dict(B=2, S=64, H=4, hd=32)
PIPE = dict(L=8, D=16, M=6, B=2)
PIPE_GRAD = dict(L=4, D=8, M=4, B=2)
EF_STEPS, EF_LR, EF_D, EF_V = 40, 5.0, 32, 64


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    B, S, H, hd = RING.values()
    ring = {n: (rng.standard_normal((B, S, H, hd)) * 0.5).astype(np.float32)
            for n in "qkv"}
    L, D, M, Bp = PIPE.values()
    pipe = {"W": (rng.standard_normal((L, D, D)) * D ** -0.5).astype(
                np.float32),
            "xs": rng.standard_normal((M, Bp, D)).astype(np.float32)}
    L, D, M, Bp = PIPE_GRAD.values()
    pipe_grad = {"W": (rng.standard_normal((L, D, D)) * 0.3).astype(
                     np.float32),
                 "xs": rng.standard_normal((M, Bp, D)).astype(np.float32)}
    # per-rank gradients over two rounds; in the first, rank r's leaf
    # "t" is (r + 1) x ties, so the shared scale is exactly 4 and rank
    # 3's values fall on ties at .5
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5],
                    np.float32)
    grads = [[{"w": rng.standard_normal((4, 256)).astype(np.float32),
               "b": rng.standard_normal((32,)).astype(np.float32),
               "t": ties * (r + 1) if rnd == 0 else
               rng.standard_normal((8,)).astype(np.float32)}
              for r in range(WORLD)] for rnd in range(2)]
    ef = {"emb": (rng.standard_normal((EF_V, EF_D)) * 0.1).astype(
              np.float32),
          "W1": (rng.standard_normal((EF_D, 64)) * 0.1).astype(np.float32),
          "W2": (rng.standard_normal((64, EF_V)) * 0.1).astype(np.float32)}
    toks = rng.integers(0, EF_V, (16, 12)).astype(np.int64)
    return {"ring": ring, "pipe": pipe, "pipe_grad": pipe_grad,
            "grads": grads, "ef": ef, "toks": toks}


def _stage(W, x):
    """One stage: tanh(x @ W[l]) over its layers."""
    for i in range(W.shape[0]):
        x = torch.tanh(x @ W[i])
    return x


def _ef_loss(p, toks):
    x = p["emb"][toks[:, :-1]]
    logits = torch.tanh(x @ p["W1"]) @ p["W2"]
    y = toks[:, 1:]
    lse = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, y[..., None])[..., 0]
    return (lse - gold).mean()


def _ef_train(rank, world, inp, compressed: bool, group) -> list:
    """tests/test_compressed_training.py's run: data parallel over the
    group, each rank on its rows of one fixed batch, SGD at lr 5."""
    p = {k: torch.from_numpy(v.copy()) for k, v in inp["ef"].items()}
    res = comp.init_residuals(p)
    n = inp["toks"].shape[0] // world
    toks = torch.from_numpy(inp["toks"][rank * n:(rank + 1) * n])
    losses = []
    for _ in range(EF_STEPS):
        live = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        loss = _ef_loss(live, toks)
        grads = dict(zip(live, torch.autograd.grad(loss, list(
            live.values()))))
        if compressed:
            grads, res = comp.crosspod_mean_compressed(grads, res, group)
        else:
            for g in grads.values():
                torch.distributed.all_reduce(g, group=group)
                g.div_(world)
        p = {k: live[k].detach() - EF_LR * grads[k] for k in p}
        loss = loss.detach().clone()
        torch.distributed.all_reduce(loss, group=group)
        losses.append(float(loss) / world)
    return losses


def rank_collectives(rank, world, inp):
    out = {}
    # ring attention over a ("model",) mesh; every rank holds the whole
    # q, k, v and keeps its sequence shard
    ring_mesh = make_mesh((world,), ("model",), device="cpu")
    q, k, v = (torch.from_numpy(inp["ring"][n]) for n in "qkv")
    for causal in (True, False):
        got = ring_attention(q, k, v, ring_mesh, "model", causal=causal)
        out[f"ring_local_{causal}"] = got.to_local().numpy()
        out[f"ring_full_{causal}"] = got.full_tensor().numpy()

    # the pipeline over ("pipe",): outputs, then gradients
    pipe_mesh = make_mesh((world,), ("pipe",), device="cpu")
    run = gpipe(_stage, pipe_mesh, "pipe")
    with torch.no_grad():
        out["pipe"] = run(stack_stages(
            {"w": torch.from_numpy(inp["pipe"]["W"])}, world)["w"],
            torch.from_numpy(inp["pipe"]["xs"])).numpy()
    W = torch.from_numpy(inp["pipe_grad"]["W"]).requires_grad_(True)
    loss = (run(stack_stages({"w": W}, world)["w"],
                torch.from_numpy(inp["pipe_grad"]["xs"])) ** 2).mean()
    loss.backward()
    per = W.shape[0] // world
    out["pipe_loss"] = float(loss.detach())
    out["pipe_grad"] = W.grad[rank * per:(rank + 1) * per].numpy()
    out["pipe_grad_elsewhere"] = float(torch.cat(
        [W.grad[:rank * per], W.grad[(rank + 1) * per:]]).abs().sum())

    # compression over ("pod",): two rounds, the residuals carried
    pod_mesh = make_mesh((world,), ("pod",), device="cpu")
    group = pod_mesh.get_group("pod")
    res = comp.init_residuals({k: torch.from_numpy(v) for k, v in
                               inp["grads"][0][rank].items()})
    for rnd in range(2):
        g = {k: torch.from_numpy(v) for k, v in
             inp["grads"][rnd][rank].items()}
        mean, res = comp.crosspod_mean_compressed(g, res, group)
        out[f"comp_{rnd}"] = {kk: vv.numpy() for kk, vv in mean.items()}
        out[f"res_{rnd}"] = {kk: vv.numpy() for kk, vv in res.items()}
    out["ef_exact"] = _ef_train(rank, world, inp, False, group)
    out["ef_comp"] = _ef_train(rank, world, inp, True, group)
    return out


# the reference's ring attention and gpipe (under jax.set_mesh) on 4
# placeholder devices, on the same arrays
def _reference(inp, tmp_path) -> dict:
    import test_torch_common as tc

    src, dst = tmp_path / "ref_in.npz", tmp_path / "ref_out.npz"
    np.savez(src, **inp["ring"], W=inp["pipe"]["W"], xs=inp["pipe"]["xs"])
    tc.run_reference(f"""
    import numpy as np
    import jax, jax.numpy as jnp
    import repro
    from repro.distributed.ring_attention import ring_attention
    from repro.distributed.pipeline import gpipe, stack_stages
    from repro.launch.mesh import make_mesh

    a = np.load({str(src)!r})
    out = {{}}
    mesh = make_mesh((4,), ("model",))
    for causal in (True, False):
        out[f"ring_{{causal}}"] = np.asarray(ring_attention(
            jnp.asarray(a["q"]), jnp.asarray(a["k"]), jnp.asarray(a["v"]),
            mesh, "model", causal=causal))

    def stage_fn(stage_W, x):
        def body(h, W):
            return jnp.tanh(h @ W), None
        h, _ = jax.lax.scan(body, x, stage_W)
        return h

    pmesh = make_mesh((4,), ("pipe",))
    with jax.set_mesh(pmesh):
        out["pipe"] = np.asarray(gpipe(stage_fn, pmesh, "pipe")(
            stack_stages({{"w": jnp.asarray(a["W"])}}, 4)["w"],
            jnp.asarray(a["xs"])))
    np.savez({str(dst)!r}, **out)
    """, devices=4)
    with np.load(dst) as z:
        return dict(z)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import test_torch_common as tc

    tmp = tmp_path_factory.mktemp("collectives")
    inp = _inputs()
    ranks = tc.spawn_group("test_torch_collectives:rank_collectives", WORLD,
                           tmp, args=(inp,))
    return inp, ranks, _reference(inp, tmp)


# ------------------------------------------------------------ ring
@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_reference_and_full(results, causal):
    inp, ranks, ref = results
    got = np.concatenate([r[f"ring_local_{causal}"] for r in ranks], axis=1)
    for r in ranks:     # every rank gathers the same whole output
        np.testing.assert_array_equal(r[f"ring_full_{causal}"], got)
    q, k, v = (torch.from_numpy(inp["ring"][n]) for n in "qkv")
    full = sdpa_plain(q, k, v, causal=causal).numpy()
    assert got.shape == full.shape
    np.testing.assert_allclose(got, full, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, ref[f"ring_{causal}"], rtol=0,
                               atol=1e-5)


# ------------------------------------------------------------ pipeline
def _sequential(W, xs):
    out = []
    for m in range(xs.shape[0]):
        h = xs[m]
        for i in range(W.shape[0]):
            h = torch.tanh(h @ W[i])
        out.append(h)
    return torch.stack(out)


def test_gpipe_matches_reference_and_sequential(results):
    inp, ranks, ref = results
    want = _sequential(torch.from_numpy(inp["pipe"]["W"]),
                       torch.from_numpy(inp["pipe"]["xs"])).numpy()
    for r in ranks:
        np.testing.assert_allclose(r["pipe"], want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ranks[0]["pipe"], ref["pipe"], rtol=0,
                               atol=1e-5)


def test_gpipe_gradients_match_sequential_autograd(results):
    inp, ranks, _ = results
    W = torch.from_numpy(inp["pipe_grad"]["W"]).requires_grad_(True)
    loss = (_sequential(W, torch.from_numpy(inp["pipe_grad"]["xs"])) ** 2
            ).mean()
    loss.backward()
    for r in ranks:
        assert abs(r["pipe_loss"] - float(loss.detach())) <= 1e-6
        assert r["pipe_grad_elsewhere"] == 0.0   # other stages' rows
    got = np.concatenate([r["pipe_grad"] for r in ranks])
    np.testing.assert_allclose(got, W.grad.numpy(), rtol=0, atol=1e-5)


# ------------------------------------------------------------ compression
def test_quantize_and_compress_tree_match_reference():
    import jax
    import jax.numpy as jnp

    from repro.distributed import compression as jcomp

    rng = np.random.default_rng(3)
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5],
                    np.float32)
    for x in (ties, rng.standard_normal(300).astype(np.float32) * 3,
              np.zeros(5, np.float32)):
        q, s = comp.quantize_int8(torch.from_numpy(x))
        jq, js = jcomp.quantize_int8(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert q.dtype == torch.int8
        assert s.numpy().tobytes() == np.asarray(js).tobytes()
        np.testing.assert_array_equal(
            jcomp.dequantize_int8(jq, js),
            comp.dequantize_int8(q, s).numpy())
    grads = {"a": rng.standard_normal((6, 7)).astype(np.float32),
             "b": {"c": ties.copy()}}
    res = {"a": rng.standard_normal((6, 7)).astype(np.float32) * 0.01,
           "b": {"c": np.zeros(8, np.float32)}}
    tq, ts, tr_ = comp.compress_tree(
        jax.tree.map(torch.from_numpy, grads),
        jax.tree.map(torch.from_numpy, res))
    jq, js, jr = jcomp.compress_tree(jax.tree.map(jnp.asarray, grads),
                                     jax.tree.map(jnp.asarray, res))
    for a, b in zip(jax.tree.leaves((tq, ts, tr_)),
                    jax.tree.leaves((jq, js, jr))):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    zeros = comp.init_residuals(jax.tree.map(torch.from_numpy, grads))
    jzeros = jcomp.init_residuals(jax.tree.map(jnp.asarray, grads))
    for a, b in zip(jax.tree.leaves(zeros), jax.tree.leaves(jzeros)):
        assert a.dtype == torch.float32
        assert a.numpy().tobytes() == np.asarray(b).tobytes()


def _numpy_crosspod(grads, residuals):
    """compression.py:47-66 in numpy, over a list of per-rank trees."""
    n = np.int32(len(grads))
    outs = [{} for _ in grads]
    new_res = [{} for _ in grads]
    for key in grads[0]:
        g32 = [g[key].astype(np.float32) + r[key]
               for g, r in zip(grads, residuals)]
        s = max(np.maximum(np.max(np.abs(x)), np.float32(1e-12))
                / np.float32(127.0) for x in g32)
        qs = [np.clip(np.round(x / s), -127, 127).astype(np.int8)
              for x in g32]
        total = np.sum([q.astype(np.int32) for q in qs], axis=0)
        for i, (x, q) in enumerate(zip(g32, qs)):
            new_res[i][key] = x - q.astype(np.float32) * s
            outs[i][key] = (total.astype(np.float32) * s
                            / n.astype(np.float32)).astype(np.float32)
    return outs, new_res


def test_crosspod_mean_compressed_matches_numpy_transcription(results):
    """Bit for bit against compression.py:47-66 written in numpy. The
    reference's own ``crosspod_mean_compressed`` raises a
    ShardingTypeError under this host's JAX (tests/test_distributed.py::
    test_compressed_crosspod_allreduce), so it cannot be run here."""
    inp, ranks, _ = results
    res = [{k: np.zeros_like(v) for k, v in g.items()}
           for g in inp["grads"][0]]
    for rnd in range(2):
        want, res = _numpy_crosspod(inp["grads"][rnd], res)
        for r, rank in enumerate(ranks):
            for key in want[r]:
                assert rank[f"comp_{rnd}"][key].tobytes() == \
                    want[r][key].tobytes(), (rnd, r, key)
                assert rank[f"res_{rnd}"][key].tobytes() == \
                    res[r][key].tobytes(), (rnd, r, key)
    # the ties round half to even: rank r's "t" is (r + 1) * ties under
    # the shared scale of rank 3's 4 * 127 / 127
    exact = np.mean([g["t"] for g in inp["grads"][0]], axis=0)
    assert np.abs(ranks[0]["comp_0"]["t"] - exact).max() <= 4 * 0.5


def test_error_feedback_training_tracks_exact(results):
    """tests/test_compressed_training.py's criterion on 4 gloo ranks."""
    _, ranks, _ = results
    exact, compd = ranks[0]["ef_exact"], ranks[0]["ef_comp"]
    for r in ranks[1:]:
        assert r["ef_exact"] == exact and r["ef_comp"] == compd
    assert compd[-1] < compd[0] - 0.2           # it learns
    assert abs(compd[-1] - exact[-1]) < 0.1     # tracks the exact run
