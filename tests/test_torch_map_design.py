"""The reduction of the ``map_decide`` CUDA kernel, emulated on the CPU and
held against the plain version and the JAX package's Pallas kernel.

The kernel (``csrc/map_fused.cu``) runs only on the card. What its design
changes is the order in which the per-machine argmins meet the tasks; this
file partitions the tasks exactly as the kernel does and merges them in
its order:

- a row is split over a cluster of ``cluster_size(B)`` blocks of 128
  threads (1 from 2 x 132 rows up, else 2 or 4);
- the tasks from the row's first 16-byte boundary (flat index a multiple of
  4) to its last go in groups of 4, group q to the cluster's thread q mod
  (size x 128); the rest go one by one, the k-th before the groups and the
  k-th after them each to thread k mod (size x 128), so that a thread meets
  its tasks in increasing index order;
- for M <= 8 each thread keeps, per slot (suffered pool, then the other,
  MS = 4 or 8 slots each), the task whose 32-bit order key is strictly
  lowest in its visiting order: since that order is increasing in the task
  index, this is its minimum of packed (order key, task) u64s, which is
  what is emulated; the warp merges them with xor shuffles (16, 8, 4, 2, 1), lane 0
  of each warp writes them, the block takes the minimum over its 4 warps
  in order and block 0 that over the cluster's blocks in order; above 8
  machines every task goes to a shared atomicMin of its block (any order)
  and the cluster merges the blocks the same way.

The merged (key, task) pairs must equal ``map_decide_plain``'s and the
Pallas kernel's (run in interpret mode, as the JAX package's own tests run
it) for M in {1, 3, 4, 8, 20}, on rows below and above the split, with N
off the 4-task grain, many equal keys, -0.0 and +0.0 (equal to the
reference, as jnp's < and torch.equal hold them) and keys at BIG and
beyond (no nominee).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.map_fused import map_decide as jax_map_decide
from repro_torch.core.equations import BIG
from repro_torch.kernels.map_fused import ops as mf
from test_torch_kernels_cuda import kernel_inputs

THREADS, WARP = 128, 32
SPLIT_BELOW_ROWS = 2 * 132


def cluster_size(B: int) -> int:
    if B >= SPLIT_BELOW_ROWS:
        return 1
    return 2 if 2 * B >= SPLIT_BELOW_ROWS else 4


def order_key(key: np.ndarray) -> np.ndarray:
    """The kernel's order-preserving float -> uint32 map, -0.0 folded onto
    +0.0."""
    u = np.ascontiguousarray(key, np.float32).view(np.uint32).copy()
    u[(u & 0x7FFFFFFF) == 0] = 0
    neg = (u & 0x80000000) != 0
    return np.where(neg, ~u, u | 0x80000000).astype(np.uint32)


def from_order_key(k: np.ndarray) -> np.ndarray:
    k = k.astype(np.uint32)
    u = np.where((k & 0x80000000) != 0, k & 0x7FFFFFFF, ~k).astype(np.uint32)
    return u.view(np.float32)


def owners(B: int, N: int, b: int, vec: bool = True) -> np.ndarray:
    """Per task of row b, the cluster thread (rank x 128 + thread) that
    takes it."""
    base, end = b * N, b * N + N
    a0 = min(-(-base // 4) * 4, end) if vec else end
    a1 = max(a0, end // 4 * 4) if vec else end
    stride = cluster_size(B) * THREADS
    own = np.empty(N, np.int64)
    head, n_quad = a0 - base, (a1 - a0) // 4
    own[:head] = np.arange(head) % stride
    own[a1 - base:] = np.arange(end - a1) % stride
    quads = np.arange(n_quad)
    for u in range(4):
        own[head + 4 * quads + u] = quads % stride
    return own


def kernel_argmins(key, best, valid, suffered, M: int, vec: bool = True,
                   seed: int = 0):
    """The kernel's per-machine argmins from per-task (key, best, valid,
    suffered), all (B, N), merged as the kernel merges them. Returns
    (hi_key, hi_task, lo_key, lo_task) as torch tensors."""
    key, best, valid, suffered = (np.asarray(a) for a in
                                  (key, best, valid, suffered))
    B, N = key.shape
    cs = cluster_size(B)
    pool = 4 if M <= 4 else 8 if M <= 8 else M
    none = np.uint64(int(order_key(np.float32([BIG]))[0]) << 32)
    packed = (order_key(key).astype(np.uint64) << np.uint64(32)) \
        | np.arange(N, dtype=np.uint64)[None, :]
    slot = np.where(suffered, 0, pool) + best
    rng = np.random.default_rng(seed)
    out = np.full((B, 2 * pool), none, np.uint64)
    for b in range(B):
        own = owners(B, N, b, vec)
        ok = valid[b]
        blocks = np.full((cs, 2 * pool), none, np.uint64)
        if M <= 8:
            per_thread = np.full((cs * THREADS, 2 * pool), none, np.uint64)
            np.minimum.at(per_thread, (own[ok], slot[b][ok]), packed[b][ok])
            lanes = per_thread.reshape(cs, THREADS // WARP, WARP, 2 * pool)
            lane = np.arange(WARP)
            for off in (16, 8, 4, 2, 1):              # xor shuffles
                lanes = np.minimum(lanes, lanes[:, :, lane ^ off])
            warp0 = lanes[:, :, 0]                    # lane 0 of each warp
            for w in range(THREADS // WARP):          # the block, in order
                blocks = np.minimum(blocks, warp0[:, w])
        else:
            for i in rng.permutation(np.flatnonzero(ok)):   # atomicMin
                r = own[i] // THREADS
                blocks[r, slot[b, i]] = min(blocks[r, slot[b, i]],
                                            packed[b, i])
        merged = blocks[0]
        for r in range(1, cs):                        # block 0, in order
            merged = np.minimum(merged, blocks[r])
        out[b] = merged
    keys = from_order_key((out >> np.uint64(32)).astype(np.uint32))
    tasks = (out & np.uint64(0xFFFFFFFF)).astype(np.int64)
    res = []
    for lo in (0, pool):
        res += [torch.from_numpy(keys[:, lo:lo + M].copy()),
                torch.from_numpy(tasks[:, lo:lo + M].copy())]
    return tuple(res)


def assert_same(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, torch.as_tensor(np.asarray(w))), (what, i)


KINDS = [("min_energy_feasible", "value", "stale_hopeless"),
         ("min_completion", "urgency", "stale"),
         ("random_hash", "fcfs", "stale_hopeless")]


def test_partition_covers_every_task_once():
    for B, N in ((3, 1001), (150, 2000), (300, 999), (5, 7)):
        for b in (0, 1, B - 1):
            own = owners(B, N, b)
            assert own.shape == (N,) and own.min() >= 0
            assert own.max() < cluster_size(B) * THREADS
    assert [cluster_size(B) for B in (1, 131, 132, 263, 264, 1200)] == \
        [4, 4, 2, 2, 1, 1]


@pytest.mark.parametrize("M", [1, 3, 4, 8, 20])
@pytest.mark.parametrize("B", [3, 300])
def test_merge_equals_plain(B, M):
    x = {k: torch.as_tensor(v) for k, v in
         kernel_inputs(B, 1001, M, 4, seed=M).items()}
    args = (x["now"], x["start"], x["p_dyn"], x["qfree"], x["eet"],
            x["deadline"], x["pending"], x["task_type"])
    for nom, key, drop in KINDS:
        kw = dict(nominator=nom, phase2_key=key, drop_rule=drop)
        _, k, best, valid = mf.map_decide_tasks(*args, **kw)
        got = kernel_argmins(k, best, valid, x["suffered"], M)
        want = mf.map_decide_plain(*args, x["suffered"], **kw)[1:]
        assert_same(got, want, (B, M, kw))


@pytest.mark.parametrize("M", [1, 3, 4, 8, 20])
def test_merge_equals_pallas(M):
    """Rows below the split (a cluster of 4 blocks per row), the Pallas
    kernel row by row."""
    B, N = 3, 1001
    x = kernel_inputs(B, N, M, 4, seed=M + 1)
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    kw = dict(nominator="min_energy_feasible", phase2_key="deadline",
              drop_rule="stale_hopeless")
    _, k, best, valid = mf.map_decide_tasks(
        t["now"], t["start"], t["p_dyn"], t["qfree"], t["eet"],
        t["deadline"], t["pending"], t["task_type"], **kw)
    got = kernel_argmins(k, best, valid, t["suffered"], M)
    for b in range(B):
        ref = jax_map_decide(
            jnp.float32(x["now"][b]), jnp.asarray(x["start"][b]),
            jnp.asarray(x["p_dyn"]), jnp.asarray(x["qfree"][b]),
            jnp.asarray(x["eet"]), jnp.asarray(x["deadline"][b]),
            jnp.asarray(x["pending"][b]),
            jnp.asarray(x["task_type"][b].astype(np.int32)),
            jnp.asarray(x["suffered"][b]), **kw, interpret=True)
        for i, (g, r) in enumerate(zip(got, ref[1:])):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(r),
                                          err_msg=f"output {i} row {b}")


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("M", [1, 3, 4, 8, 20])
@pytest.mark.parametrize("B,N", [(3, 1001), (7, 13), (264, 258)])
def test_merge_of_ties_signed_zeros_and_big(B, N, M, vec):
    """Keys drawn from a handful of values (ties everywhere), -0.0 beside
    +0.0, BIG and above BIG: the partitioned merge equals the plain
    version's reduction (``argmin_by_machine``), with the task arrays read
    in groups of 4 or one by one (unaligned arrays)."""
    r = np.random.default_rng(B * 31 + M)
    values = np.float32([-0.0, 0.0, 1.0, -1.0, 2.5, BIG, 2e30, -3e30])
    key = values[r.integers(0, values.size, (B, N))]
    best = r.integers(0, M, (B, N))
    valid = r.random((B, N)) < 0.7
    suffered = r.random((B, N)) < 0.4
    got = kernel_argmins(key, best, valid, suffered, M, vec=vec, seed=B)
    want = mf.argmin_by_machine(torch.from_numpy(key),
                                torch.from_numpy(best),
                                torch.from_numpy(valid),
                                torch.from_numpy(suffered), M)
    assert_same(got, want, (B, N, M, vec))
