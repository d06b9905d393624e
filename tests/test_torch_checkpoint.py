"""The port's checkpoints against the JAX package's, and its fault-tolerant
loop, on the CPU.

A checkpoint is written by one package and restored by the other: the
same layout (``step_<N>/arrays.npz`` + ``meta.json``), leaf names
(``jax.tree_util.keystr``), bfloat16 as uint16 bits and blake2b digest,
so every leaf comes back bit for bit with its dtype. The restart tests
are ``tests/test_fault_tolerance.py``'s, run on the port.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import registry as jreg
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro_torch import interop
from repro_torch import tree as tr
from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry as treg
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as ttf
from repro_torch.optim import AdamW, AdamWState
from repro_torch.train import TRAIN_IMPLS
from repro_torch.train.loop import (
    SimulatedFailure,
    TrainJob,
    run,
    run_with_restarts,
)

ARCH = "qwen1.5-0.5b"
CFG = treg.get_smoke_config(ARCH).scaled(n_layers=2, d_model=64,
                                         vocab_size=512, **TRAIN_IMPLS)
JCFG = jreg.get_smoke_config(ARCH).scaled(n_layers=2, d_model=64,
                                          vocab_size=512)


def as_numpy(t):
    """A port tensor as the numpy array the reference would hold (bf16 as
    its bits, for comparison)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def jax_bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def port_state():
    """The port's params (bfloat16) and an AdamW state after one update."""
    params = ttf.init(CFG, seed=0, device="cpu")
    opt = AdamW(lr=1e-2)
    grads = tr.map_named(lambda _, p: torch.ones_like(p, dtype=torch.float32)
                         * 1e-3, params)
    params, state, _ = opt.update(grads, opt.init(params), params)
    return {"p": params, "o": state}


def jax_state():
    params = jax.jit(lambda k: jtf.init(k, JCFG))(jax.random.PRNGKey(0))
    opt = jadamw.AdamW(lr=1e-2)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 1e-3, jnp.float32),
                         params)
    params, state, _ = opt.update(grads, opt.init(params), params)
    return {"p": params, "o": state}


def test_port_checkpoint_restores_in_jax(tmp_path):
    tree = port_state()
    ckpt.save(tmp_path, 3, tree)
    pshapes = jtf.param_shapes(JCFG)
    target = {"p": pshapes,
              "o": jax.eval_shape(jadamw.AdamW().init, pshapes)}
    restored, step = jckpt.restore(tmp_path, target)     # digest verified
    assert step == 3
    want = list(tr.named_leaves(tree))
    got = jax.tree_util.tree_flatten_with_path(restored)[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == [n for n, _ in want]
    assert any(t.dtype == torch.bfloat16 for _, t in want)
    for (name, t), (_, a) in zip(want, got):
        assert str(a.dtype) == str(t.dtype).removeprefix("torch."), name
        np.testing.assert_array_equal(jax_bits(a), as_numpy(t),
                                      err_msg=name)


def test_jax_checkpoint_restores_in_port(tmp_path):
    tree = jax_state()
    jckpt.save(tmp_path, 5, tree)
    target = ttf.param_shapes(CFG)
    restored, step = ckpt.restore(
        tmp_path, {"p": target, "o": AdamW().init(target)})
    assert step == 5
    assert isinstance(restored["o"], AdamWState)
    assert restored["o"].step.dtype == torch.int32
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = list(tr.named_leaves(restored))
    assert [n for n, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (name, t), (_, a) in zip(got, want):
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(as_numpy(t), jax_bits(a), err_msg=name)
    # the reference's state also carries over through interop
    state = interop.opt_state_from_arrays(
        CFG, jax.tree.map(np.asarray, tree["o"]), device="cpu")
    for a, b in zip(tr.leaves(state), tr.leaves(restored["o"])):
        assert torch.equal(a, b)


def test_layout_and_latest_step(tmp_path):
    tree = {"x": torch.zeros(3), "b": {"c": torch.ones(2, dtype=torch.bfloat16)}}
    for s in (1, 5, 3):
        ckpt.save(tmp_path, s, tree)
    assert ckpt.latest_step(tmp_path) == 5
    assert ckpt.latest_step(tmp_path / "none") is None
    meta = json.loads((tmp_path / "step_00000005" / "meta.json").read_text())
    assert meta["names"] == ["['b']['c']", "['x']"]
    assert meta["dtypes"] == ["bfloat16", "float32"]
    assert meta["shapes"] == [[2], [3]]
    with np.load(tmp_path / "step_00000005" / "arrays.npz") as z:
        assert z["a0"].dtype == np.uint16
    assert not list(tmp_path.glob(".tmp_*"))
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "none", tree)


def test_container_corruption_raises(tmp_path):
    tree = {"x": torch.arange(8.0)}
    ckpt.save(tmp_path, 1, tree)
    f = tmp_path / "step_00000001" / "arrays.npz"
    data = bytearray(f.read_bytes())
    data[-20] ^= 0xFF
    f.write_bytes(bytes(data))
    with pytest.raises(IOError, match="digest"):
        ckpt.restore(tmp_path, tree)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_digest_mismatch_raises(tmp_path, writer):
    """A well-formed container whose values changed after the digest was
    taken, in a checkpoint of either package, fails both restores."""
    if writer == "port":
        ckpt.save(tmp_path, 1, {"x": torch.arange(8.0)})
    else:
        jckpt.save(tmp_path, 1, {"x": jnp.arange(8.0)})
    f = tmp_path / "step_00000001" / "arrays.npz"
    with np.load(f) as z:
        a = z["a0"].copy()
    a[3] += 1.0
    np.savez(f, a0=a)
    with pytest.raises(IOError, match="digest mismatch"):
        ckpt.restore(tmp_path, {"x": torch.zeros(8)})
    with pytest.raises(IOError, match="digest mismatch"):
        jckpt.restore(tmp_path, {"x": jnp.zeros(8)})
    restored, _ = ckpt.restore(tmp_path, {"x": torch.zeros(8)}, verify=False)
    assert float(restored["x"][3]) == 4.0


def test_restore_checks_the_target(tmp_path):
    ckpt.save(tmp_path, 1, {"x": torch.zeros(4)})
    with pytest.raises(KeyError, match="missing"):
        ckpt.restore(tmp_path, {"y": torch.zeros(4)})
    with pytest.raises(ValueError, match="target"):
        ckpt.restore(tmp_path, {"x": torch.zeros(5)})
    with pytest.raises(ValueError, match="target"):
        ckpt.restore(tmp_path, {"x": torch.zeros(4, dtype=torch.bfloat16)})
    restored, _ = ckpt.restore(
        tmp_path, {"x": torch.empty(4, device="meta")}, device="cpu")
    assert restored["x"].device.type == "cpu"


def test_async_save_is_not_torn_by_an_in_place_update(tmp_path):
    """The leaves are on the host before save returns: updating the
    tensors in place while the thread writes changes nothing on disk."""
    x = torch.arange(1 << 20, dtype=torch.float32)
    w = torch.ones(1 << 16, dtype=torch.bfloat16)
    want = x.clone(), w.clone()
    t = ckpt.save(tmp_path, 7, {"x": x, "w": w}, blocking=False)
    x.add_(1.0)
    w.mul_(3.0)
    t.join(timeout=60)
    assert not t.is_alive()
    restored, step = ckpt.restore(tmp_path, {"x": x, "w": w})
    assert step == 7
    assert torch.equal(restored["x"], want[0])
    assert torch.equal(restored["w"], want[1])


# --------------------------------------------------------------------------
# The fault-tolerant loop (tests/test_fault_tolerance.py on the port)
# --------------------------------------------------------------------------
def _job(d, steps=12, **kw):
    return TrainJob(cfg=CFG, steps=steps, batch=2, seq=16, ckpt_dir=str(d),
                    ckpt_every=4, lr=1e-3, ckpt_async=False, device="cpu",
                    **kw)


def test_restart_resumes_from_checkpoint(tmp_path):
    run(_job(tmp_path, steps=8))
    job = _job(tmp_path / "b", steps=16)
    _, _, hist, restarts = run_with_restarts(
        job, failures={10: SimulatedFailure("boom")})
    assert restarts == 1
    assert hist[0]["step"] == 8 and hist[-1]["step"] == 15
    assert ckpt.latest_step(tmp_path / "b") == 16


@pytest.mark.parametrize("ckpt_async", [False, True])
def test_restart_is_bit_exact(tmp_path, ckpt_async):
    """Uninterrupted run == run interrupted at step 8 (the same final
    params and optimizer state, bit for bit). The restart resumes at the
    checkpoint of step 8, an async one included: a failing incarnation
    lands its save first."""
    pa, sa, _ = run(_job(tmp_path / "a", steps=12))
    job_b = _job(tmp_path / "b", steps=12)
    job_b.ckpt_async = ckpt_async
    pb, sb, hist, restarts = run_with_restarts(
        job_b, failures={8: SimulatedFailure("preempted")})
    assert restarts == 1 and hist[0]["step"] == 8
    for a, b in zip(tr.leaves((pa, sa)), tr.leaves((pb, sb))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_loss_decreases():
    cfg = CFG.scaled(vocab_size=256)
    job = TrainJob(cfg=cfg, steps=40, batch=8, seq=64, lr=1e-2,
                   ckpt_dir=None, device="cpu")
    _, _, hist = run(job)
    first5 = np.mean([h["loss"] for h in hist[:5]])
    last5 = np.mean([h["loss"] for h in hist[-5:]])
    assert last5 < first5 - 0.5  # clearly learning, not noise


def test_loop_refuses_the_kernel_path(tmp_path):
    job = _job(tmp_path, steps=2)
    job.cfg = CFG.scaled(attn_impl="kernel")
    with pytest.raises(ValueError, match="no backward"):
        run(job)


# --------------------------------------------------------------------------
# launch/train.py
# --------------------------------------------------------------------------
def test_launch_train_runs_and_resumes(tmp_path, capsys):
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "4",
            "--seq", "16", "--ckpt", str(tmp_path), "--ckpt-every", "3"]
    assert launch_train.main(args + ["--steps", "5"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("device=cpu attn_impl=plain ssm_impl=plain")
    assert out[1].startswith(f"arch={ARCH} params=")
    assert out[2].startswith("step     0 loss ") and "tok/s" in out[2]
    assert out[-1].startswith("step     4 loss ")
    assert ckpt.latest_step(tmp_path) == 5
    assert launch_train.main(args + ["--steps", "7"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1] == "restored from step 5"
    assert out[-1].startswith("step     6 loss ")


@pytest.mark.parametrize("flags", [["--production-mesh"],
                                   ["--model-axis", "2"]])
def test_launch_train_refuses_a_mesh(flags, capsys):
    assert launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu"]
                             + flags) == 2
    assert "distributed" in capsys.readouterr().out
