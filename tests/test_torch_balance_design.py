"""The ``balance_scan`` CUDA kernel's partition and walk, emulated on the
CPU and held against the plain version and the JAX package's Pallas
kernel.

The kernel (``csrc/balance_scan.cu``) runs only on the card. This file
replays its design step by step, with the constants read from the source:

- one block of THREADS threads per replicate walks its row in tiles of
  THREADS x ITEMS tasks, thread t taking the ITEMS consecutive tasks from
  t x ITEMS of the tile (how they are loaded, 16 bytes at a time or one by
  one, changes no value);
- a warp-level inclusive scan (shuffles up by 1, 2, ..., 16) of each
  thread's count of new tasks, the warps' sums added in warp order, gives
  each task its rank c within the tile, and each new task writes its code
  (take the argmin, its home, or nothing for a home outside [0, F)) at its
  rank;
- warp 0 walks the ranks: lane l holds the loads of sites l, l + 32, ...
  (the template's R registers); best[j] is the argmin before rank j's
  increment, taken from packed 32-bit keys (load << SITE_BITS | site, one
  warp minimum) where 0 <= load0 and max(load0) + N < PACK_LOADS_BELOW,
  else by each lane's scan of its registers in rising site order and an
  xor-shuffle reduction of (load, site) pairs; best[n] follows the tile's
  last increment, and the loads carry into the next tile;
- every task takes best[c] if it is a target, else its home (the kernel
  stages the tile's sites in shared memory and stores them two at a time
  by neighbouring threads, which changes no value).

The emulation must equal ``balance_scan_plain`` and the Pallas kernel (in
interpret mode, as the JAX package's own tests run it) for F in {1, 3, 8,
32, 37}, densities from 0 to 1, all loads tied, dead sites at +1,000,000,
N off every vector grain, loads that take the 64-bit path, and more new
tasks than one tile holds (with the kernel's tile, and with a small one
so that many tiles carry their loads).
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.map_fused import balance_scan as jax_balance_scan
from repro_torch.kernels import map_fused
from repro_torch.kernels.map_fused import ops as mf

SOURCE = (pathlib.Path(mf.__file__).resolve().parents[1] / "csrc"
          / "balance_scan.cu").read_text()


def constant(name: str) -> int:
    m = re.search(rf"constexpr [\w ]+ {name} = ([^;]+);", SOURCE)
    return int(eval(m.group(1).replace("LL", "")))   # e.g. (1LL << 22) - 1


THREADS, ITEMS = constant("THREADS"), constant("ITEMS")
SITE_BITS = constant("SITE_BITS")
PACK_LOADS_BELOW = constant("PACK_LOADS_BELOW")
TAKE_BEST, NO_SITE = constant("TAKE_BEST"), constant("NO_SITE")
WARP = 32
LLONG_MAX = np.iinfo(np.int64).max
LANES = np.arange(WARP)


def registers(F: int) -> int:
    """The template's R: loads per lane, ceil(F / 32) rounded up to the
    instances 1, 2, 4, 8, 32."""
    r = -(-F // WARP)
    return next(x for x in (1, 2, 4, 8, 32) if r <= x)


def warp_scan_exclusive(cnt: np.ndarray) -> np.ndarray:
    """(B, T) per-thread counts -> each thread's count of new tasks in the
    threads before it, by the kernel's shuffle-up scan and warp sums."""
    B, T = cnt.shape
    w = cnt.reshape(B, T // WARP, WARP)
    incl = w.copy()
    off = 1
    while off < WARP:
        up = np.zeros_like(incl)
        up[:, :, off:] = incl[:, :, :-off]
        incl = incl + up                    # lanes below off add nothing
        off *= 2
    sums = incl[:, :, -1]
    earlier = np.cumsum(sums, axis=1) - sums
    return (incl - w + earlier[:, :, None]).reshape(B, T)


def warp_argmin(v: np.ndarray, s: np.ndarray) -> np.ndarray:
    """The xor-shuffle reduction of (load, site) pairs over the 32 lanes,
    lowest pair wins; every lane must end with the same site."""
    for off in (16, 8, 4, 2, 1):
        ov, os_ = v[:, LANES ^ off], s[:, LANES ^ off]
        take = (ov < v) | ((ov == v) & (os_ < s))
        v, s = np.where(take, ov, v), np.where(take, os_, s)
    assert (s == s[:, :1]).all()
    return s[:, 0]


def argmin_site(load: np.ndarray, F: int, packed: np.ndarray) -> np.ndarray:
    """Warp 0's argmin per row from its (B, R, 32) registers."""
    R = load.shape[1]
    f = WARP * np.arange(R)[:, None] + LANES                 # (R, 32)
    real = f < F
    # packed: each lane's minimum key, then the warp's minimum
    key = np.where(real, (np.where(real, load, 0).astype(np.uint64)
                          << np.uint64(SITE_BITS)) | f.astype(np.uint64),
                   np.uint64(0xFFFFFFFF))
    by_key = key.min(axis=1).min(axis=1) & np.uint64((1 << SITE_BITS) - 1)
    # 64-bit: each lane scans its registers in rising site order
    v, s = load[:, 0].copy(), np.broadcast_to(LANES, load[:, 0].shape).copy()
    for i in range(1, R):
        lower = load[:, i] < v
        v = np.where(lower, load[:, i], v)
        s = np.where(lower, WARP * i + LANES, s)
    return np.where(packed, by_key.astype(np.int64), warp_argmin(v, s))


def emulate(load0, unassigned, target, home, threads=THREADS, items=ITEMS):
    """The kernel's sites, and per row whether it took the packed keys."""
    load0, home = np.asarray(load0, np.int64), np.asarray(home, np.int64)
    B, F = load0.shape
    N = unassigned.shape[1]
    tile = threads * items
    R = registers(F)
    f = WARP * np.arange(R)[:, None] + LANES
    load = np.full((B, R, WARP), LLONG_MAX, np.int64)
    load[:, f < F] = load0[:, f[f < F]]
    packed = (load0.min(1) >= 0) & (load0.max(1) < PACK_LOADS_BELOW - N)
    rows = np.arange(B)
    sites = np.empty((B, N), np.int64)
    for t0 in range(0, N, tile):
        k = t0 + np.arange(tile)
        inside = k < N
        kk = np.minimum(k, N - 1)
        nw = unassigned[:, kk] & inside
        tg = target[:, kk] & inside
        hm = np.where(inside, home[:, kk], 0)
        # ranks: the scan over threads, then each thread's own tasks in order
        per_thread = nw.reshape(B, threads, items)
        before = warp_scan_exclusive(per_thread.sum(2))
        rank = (before[:, :, None] + np.cumsum(per_thread, 2)
                - per_thread).reshape(B, tile)
        total = nw.sum(1)
        code = np.full((B, tile), NO_SITE, np.int64)
        in_range = (hm >= 0) & (hm < F)
        b_idx, t_idx = np.nonzero(nw)
        code[b_idx, rank[b_idx, t_idx]] = np.where(
            tg, TAKE_BEST, np.where(in_range, hm, NO_SITE))[b_idx, t_idx]
        # warp 0's walk over the ranks
        best_s = np.zeros((B, tile + 1), np.int64)
        best = argmin_site(load, F, packed)
        for j in range(int(total.max()) + 1):
            seen = j <= total           # best[j] for j in [0, total]
            best_s[seen, j] = best[seen]
            walking = j < total
            if not walking.any():
                break
            c = code[:, j]
            s = np.where(c == TAKE_BEST, best, c)
            inc = walking & (s >= 0)
            r_i, l_i = s // WARP, s % WARP
            load[rows[inc], r_i[inc], l_i[inc]] += 1
            best = np.where(inc, argmin_site(load, F, packed), best)
        out = np.where(tg, best_s[rows[:, None], rank], hm)
        sites[:, k[inside]] = out[:, inside]
    return sites, packed


def balance_case(B, N, F, density, loads, seed):
    """Admissions at ``density``, targets on half the tasks (every task in
    replicate 0), homes in [0, F) with a few outside it (-1 and F, which
    add no load), and loads all tied, small with dead sites at
    +1,000,000, or too large for the packed keys."""
    r = np.random.default_rng(seed)
    if loads == "tied":
        load0 = np.full((B, F), 3, np.int64)
    elif loads == "dead":
        load0 = r.integers(0, 6, (B, F)) + 1_000_000 * (r.random((B, F))
                                                        < 0.25)
    else:                                   # "wide": the 64-bit path
        load0 = r.integers(0, 6, (B, F)) + (1 << 22)
    unassigned = r.random((B, N)) < density
    target = r.random((B, N)) < 0.5
    target[0] = True
    home = r.integers(0, F, (B, N))
    home[r.random((B, N)) < 0.05] = -1
    home[r.random((B, N)) < 0.05] = F
    return load0.astype(np.int64), unassigned, target, home.astype(np.int64)


def plain(load0, unassigned, target, home):
    return mf.balance_scan_plain(*(torch.as_tensor(a) for a in (
        load0, unassigned, target, home))).numpy()


def test_constants_from_the_source():
    assert (THREADS, ITEMS, SITE_BITS) == (256, 16, 10)
    assert PACK_LOADS_BELOW == (1 << 22) - 1
    assert THREADS % WARP == 0 and ITEMS % 16 == 0   # 16-byte flag loads


def test_scan_gives_exclusive_prefix():
    r = np.random.default_rng(0)
    cnt = r.integers(0, ITEMS + 1, (3, THREADS))
    np.testing.assert_array_equal(warp_scan_exclusive(cnt),
                                  np.cumsum(cnt, 1) - cnt)


@pytest.mark.parametrize("loads", ["tied", "dead", "wide"])
@pytest.mark.parametrize("density", [0.0, 0.01, 0.5, 1.0])
@pytest.mark.parametrize("F", [1, 3, 8, 32, 37])
def test_walk_equals_plain(F, density, loads):
    """The kernel's tile at N off the 16-task grain (1001), rows of every
    alignment."""
    args = balance_case(5, 1001, F, density, loads, seed=F * 7 + len(loads))
    got, packed = emulate(*args)
    assert packed.all() == (loads != "wide") and packed.any() == packed.all()
    np.testing.assert_array_equal(got, plain(*args))


@pytest.mark.parametrize("F", [1, 8, 37, 1024])
@pytest.mark.parametrize("loads", ["dead", "wide"])
def test_tiles_carry_the_loads(F, loads):
    """More new tasks than one tile: every task new over 2.4 kernel tiles,
    and a tile of 64 threads x 4 tasks over 8 tiles at density 0.5."""
    args = balance_case(2, 10_000, F, 1.0, loads, seed=F)
    np.testing.assert_array_equal(emulate(*args)[0], plain(*args))
    args = balance_case(3, 2000, F, 0.5, loads, seed=F + 1)
    got, _ = emulate(*args, threads=64, items=4)
    np.testing.assert_array_equal(got, plain(*args))


def test_no_new_task_takes_the_first_argmin():
    args = balance_case(4, 300, 8, 0.0, "dead", seed=3)
    got, _ = emulate(*args)
    load0, _, target, home = args
    want = np.where(target, load0.argmin(1)[:, None], home)
    np.testing.assert_array_equal(got, want)


def test_packed_keys_switch_at_their_limit():
    """A row whose largest load plus N reaches PACK_LOADS_BELOW walks the
    64-bit path; one below it the packed keys, with the same sites."""
    N = 100
    load0 = np.array([[0, PACK_LOADS_BELOW - N - 1, 5],
                      [0, PACK_LOADS_BELOW - N, 5],
                      [-1, 4, 5]], np.int64)
    r = np.random.default_rng(9)
    args = (load0, r.random((3, N)) < 0.7, r.random((3, N)) < 0.6,
            r.integers(0, 3, (3, N)).astype(np.int64))
    got, packed = emulate(*args)
    assert packed.tolist() == [True, False, False]
    np.testing.assert_array_equal(got, plain(*args))


@pytest.mark.parametrize("density", [0.05, 0.5, 1.0])
@pytest.mark.parametrize("F", [1, 3, 8, 32, 37])
def test_walk_equals_pallas(F, density):
    """Row by row against the Pallas kernel in interpret mode (its loads
    are int32: dead sites at +1,000,000, no 64-bit loads)."""
    load0, unassigned, target, home = balance_case(
        3, 133, F, density, "dead", seed=F)
    home = np.clip(home, 0, F - 1)             # the JAX walk's homes
    load0[1] = 3                               # a row of ties
    got, _ = emulate(load0, unassigned, target, home)
    for b in range(3):
        ref = jax_balance_scan(
            jnp.asarray(load0[b].astype(np.int32)), jnp.asarray(unassigned[b]),
            jnp.asarray(target[b]), jnp.asarray(home[b].astype(np.int32)),
            interpret=True)
        np.testing.assert_array_equal(got[b], np.asarray(ref),
                                      err_msg=f"row {b}")


def test_wrapper_on_cpu_is_the_plain_walk():
    """On CPU tensors the wrapper runs the plain version and counts no
    launch."""
    args = balance_case(3, 257, 5, 0.3, "dead", seed=1)
    before = dict(mf.LAUNCHES)
    got = map_fused.balance_scan(*(torch.as_tensor(a) for a in args))
    assert mf.LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(), emulate(*args)[0])
