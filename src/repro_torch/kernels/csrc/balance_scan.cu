// The dispatcher's least-loaded site walk for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel src/repro/kernels/map_fused/kernel.py
// balance_scan_padded (body _balance_kernel), the fused form of
// core/dispatch/base.py sequential_balance. Per replicate, task k with c_k
// new (unassigned) tasks before it sees the loads L_{c_k} after their
// increments:
//
//   best[j] = argmin(L_j), lowest site on ties
//   s_k     = target_k ? best[c_k] : home_k      (every task gets an output)
//   L_{j+1} = L_j + 1 at s_k, k the new task of rank j
//                                    (a home outside [0, F) adds nothing)
//
// load0 is taken as given (the caller adds any penalty, such as the dead
// site's +1,000,000). There is no padding: the kernel handles any N, any
// count of new tasks and F <= 1024.
//
// What bounds it on this card. Bytes: per task it reads two flags (1 B
// each) and a home site (8 B) and writes a site (8 B). At the smoke's
// shape (B = 150 replicates, N = 4000 tasks, F = 8 sites) that is about
// 10.8 MB, 3.2 us at 3.35 TB/s. Beyond the bytes, the walk over the new
// tasks is serial: each one's site depends on every earlier new task's
// increment. At an event only the tasks admitted since the last one are
// new, which is one per replicate on the federated paths.
//
// What the design does about it: one block of 256 threads per replicate
// walks its row in tiles of 4096 tasks (one tile at the paths' N).
//   1. Every thread loads its 16 consecutive tasks at once (two 16-byte
//      loads of flags, eight of homes where the row is 16-byte aligned,
//      else one by one): no load waits on another.
//   2. A block-wide exclusive scan of the unassigned flags gives each task
//      its rank c_k within the tile, and each new task writes its code
//      (take the argmin, or its home, or nothing) to shared memory in rank
//      order.
//   3. Warp 0 alone walks the ranks. Lane f holds the loads of sites f,
//      f + 32, ... in registers (between tiles in shared memory); for each rank
//      it records best[j] in shared memory and adds one at the rank's
//      site. Where the block finds 0 <= load0 and max(load0) + N below
//      2^22 - 1, the loads are packed with their site into 32-bit keys
//      (load << 10 | site) and each argmin is one __reduce_min_sync;
//      otherwise a shuffle reduction of (64-bit load, site) pairs.
//   4. Every thread computes its tasks' sites, target ? best[c_k] : home,
//      and stages them in shared memory, from where the block stores the
//      tile with neighbouring threads on neighbouring 16 bytes. Stored
//      straight from each thread's 16 tasks, a warp's 16-byte stores lie
//      128 bytes apart and each writes half sectors; on the card those
//      stores took more time than all the rest of the kernel.
// The serial depth is the count of new tasks, with no global load between
// two of them.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;                  // consecutive tasks per thread
constexpr int TILE = THREADS * ITEMS;      // tasks per tile
// Staged sites: one padding slot per ITEMS keeps a thread's writes and a
// warp's reads of the stage off each other's banks.
constexpr int STAGE = TILE + TILE / ITEMS;
constexpr int SITE_BITS = 10;              // F <= 1024
constexpr unsigned SITE_MASK = (1u << SITE_BITS) - 1;
// A packed key holds loads up to 2^22 - 2, so that no real site's key
// reaches the padding lanes' 0xffffffff.
constexpr long long PACK_LOADS_BELOW = (1LL << (32 - SITE_BITS)) - 1;
constexpr int TAKE_BEST = -2;              // code of a new target task
constexpr int NO_SITE = -1;                // code of a home outside [0, F)
constexpr unsigned FULL = 0xffffffffu;

// Lowest (load, site) pair across the warp, left in every lane.
__device__ __forceinline__ int warp_argmin(long long v, int s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const long long ov = __shfl_xor_sync(FULL, v, off);
    const int os = __shfl_xor_sync(FULL, s, off);
    if (ov < v || (ov == v && os < s)) {
      v = ov;
      s = os;
    }
  }
  return s;
}

// Site of least load, lowest site on ties. Lane l holds sites l, l + 32,
// ...; its own entries are scanned in rising site order.
template <int R>
__device__ __forceinline__ int least_loaded(const long long (&load)[R],
                                            int lane) {
  long long v = load[0];
  int s = lane;
#pragma unroll
  for (int i = 1; i < R; ++i) {
    if (load[i] < v) {
      v = load[i];
      s = 32 * i + lane;
    }
  }
  return warp_argmin(v, s);
}

// The lowest packed key across the warp (its low bits are the site).
template <int R>
__device__ __forceinline__ unsigned least_key(const unsigned (&key)[R]) {
  unsigned v = key[0];
#pragma unroll
  for (int i = 1; i < R; ++i) v = min(v, key[i]);
  return __reduce_min_sync(FULL, v);
}

// The warp's argmin site, from the packed keys or from the 64-bit loads.
template <int R, bool PACKED>
__device__ __forceinline__ int argmin_site(const unsigned (&key)[R],
                                           const long long (&load)[R],
                                           int lane) {
  if (PACKED) return (int)(least_key(key) & SITE_MASK);
  return least_loaded(load, lane);
}

// Warp 0's walk over the n ranks of one tile: best_s[j] for j in [0, n].
// ``carry`` holds the loads before the tile (site f at f, LLONG_MAX past
// F) and takes those after it.
template <int R, bool PACKED>
__device__ __forceinline__ void walk_ranks(long long* carry, const int* code,
                                           int* best_s, int n, int F,
                                           int lane) {
  long long load[R];
#pragma unroll
  for (int i = 0; i < R; ++i) load[i] = carry[32 * i + lane];
  unsigned key[R] = {};
  if (PACKED) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int f = 32 * i + lane;
      key[i] = f < F ? ((unsigned)load[i] << SITE_BITS) | (unsigned)f : FULL;
    }
  }
  int best = argmin_site<R, PACKED>(key, load, lane);
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int m = min(32, n - j0);
    const int mine_code = lane < m ? code[j0 + lane] : NO_SITE;
    int mine_best = 0;
    // Rank q + 1's code is fetched before rank q's argmin, so the
    // shuffle's latency stays off the chain of argmins.
    int c_next = __shfl_sync(FULL, mine_code, 0);
    for (int q = 0; q < m; ++q) {
      if (lane == q) mine_best = best;
      const int c = c_next;
      c_next = __shfl_sync(FULL, mine_code, (q + 1) & 31);
      const int s = c == TAKE_BEST ? best : c;     // the same in every lane
      if (s >= 0) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          if (32 * i + lane == s) {
            if (PACKED)
              key[i] += 1u << SITE_BITS;
            else
              load[i] += 1;
          }
        }
        best = argmin_site<R, PACKED>(key, load, lane);
      }
    }
    if (lane < m) best_s[j0 + lane] = mine_best;
  }
  if (lane == 0) best_s[n] = best;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (PACKED && 32 * i + lane < F)
      load[i] = (long long)(key[i] >> SITE_BITS);
    carry[32 * i + lane] = load[i];
  }
}

__device__ __forceinline__ int staged(int i) { return i + i / ITEMS; }

__device__ __forceinline__ bool byte_of(unsigned w, int i) {
  return ((w >> (8 * i)) & 0xffu) != 0;
}

template <int R>
__global__ void __launch_bounds__(THREADS) balance_scan_kernel(
    const int64_t* __restrict__ load0, const uint8_t* __restrict__ unassigned,
    const uint8_t* __restrict__ target, const int64_t* __restrict__ home,
    int64_t* __restrict__ sites, int N, int F, int vec_ok) {
  // The walk's arrays, then (once read) the tile's sites.
  __shared__ union {
    struct {
      int code[TILE];        // per new task of the tile, rank order
      int best[TILE + 1];    // the argmin rank j's span sees
    } walk;
    long long stage[STAGE];
  } sm;
  __shared__ int warp_sum[WARPS];
  __shared__ long long carry[32 * R];  // warp 0's loads between tiles
  int* const code = sm.walk.code;
  int* const best_s = sm.walk.best;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const size_t row = (size_t)b * N;
  const bool vec = vec_ok && row % 16 == 0;

  bool packed = false;
  if (warp == 0) {
    long long lo = LLONG_MAX, hi = LLONG_MIN;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int f = 32 * i + lane;
      // Lanes past F never win: their load is the largest there is, and a
      // real site with the same load has the lower index.
      const long long v = f < F ? (long long)load0[(size_t)b * F + f]
                                : LLONG_MAX;
      carry[f] = v;  // read back by this lane only
      if (f < F) {
        lo = min(lo, v);
        hi = max(hi, v);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(FULL, lo, off));
      hi = max(hi, __shfl_xor_sync(FULL, hi, off));
    }
    // N bounds the increments, so every load of the walk fits the key.
    packed = lo >= 0 && hi < PACK_LOADS_BELOW - N;
  }

  for (int t0 = 0; t0 < N; t0 += TILE) {
    // 1. This thread's ITEMS consecutive tasks, all loads in flight.
    const int k0 = t0 + tid * ITEMS;
    const bool full = vec && k0 + ITEMS <= N;
    bool nw[ITEMS], tg[ITEMS];
    long long hm[ITEMS];
    if (full) {
      const uint4 u4 = __ldg(reinterpret_cast<const uint4*>(unassigned + row +
                                                            k0));
      const uint4 g4 = __ldg(reinterpret_cast<const uint4*>(target + row + k0));
      const unsigned uw[4] = {u4.x, u4.y, u4.z, u4.w};
      const unsigned gw[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int u = 0; u < ITEMS; ++u) {
        nw[u] = byte_of(uw[u / 4], u % 4);
        tg[u] = byte_of(gw[u / 4], u % 4);
      }
      const longlong2* h2 = reinterpret_cast<const longlong2*>(home + row + k0);
#pragma unroll
      for (int p = 0; p < ITEMS / 2; ++p) {
        const longlong2 h = __ldg(h2 + p);
        hm[2 * p] = h.x;
        hm[2 * p + 1] = h.y;
      }
    } else {
#pragma unroll
      for (int u = 0; u < ITEMS; ++u) {
        const int k = k0 + u;
        const bool in = k < N;
        nw[u] = in && unassigned[row + k] != 0;
        tg[u] = in && target[row + k] != 0;
        hm[u] = in ? (long long)home[row + k] : 0;
      }
    }

    // 2. Exclusive scan of the new flags: the tile-local rank of this
    //    thread's first new task, and the tile's count.
    int cnt = 0;
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) cnt += nw[u];
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int before = incl - cnt, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int s = warp_sum[w];
      before += w < warp ? s : 0;
      total += s;
    }
    int r = before;
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      if (nw[u]) {
        code[r] = tg[u] ? TAKE_BEST
                        : (hm[u] >= 0 && hm[u] < F ? (int)hm[u] : NO_SITE);
        ++r;
      }
    }
    __syncthreads();

    // 3. The walk over the tile's ranks.
    if (warp == 0) {
      if (packed)
        walk_ranks<R, true>(carry, code, best_s, total, F, lane);
      else
        walk_ranks<R, false>(carry, code, best_s, total, F, lane);
    }
    __syncthreads();

    // 4. Every task's site, staged, then stored pair by pair: pair e of
    //    the tile (tasks 2e, 2e + 1) by thread e mod THREADS.
    long long out[ITEMS];
    r = before;
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      out[u] = tg[u] ? (long long)best_s[r] : hm[u];
      r += nw[u];
    }
    __syncthreads();  // best_s is read; the stage takes its place
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) sm.stage[staged(tid * ITEMS + u)] = out[u];
    __syncthreads();
#pragma unroll
    for (int p = 0; p < ITEMS / 2; ++p) {
      const int e = 2 * (p * THREADS + tid);
      const int k = t0 + e;
      const long long a = sm.stage[staged(e)], c = sm.stage[staged(e + 1)];
      if (vec && k + 2 <= N) {
        *reinterpret_cast<longlong2*>(sites + row + k) = make_longlong2(a, c);
      } else {
        if (k < N) sites[row + k] = (int64_t)a;
        if (k + 1 < N) sites[row + k + 1] = (int64_t)c;
      }
    }
    // The next tile writes the walk's arrays and warp_sum only after its
    // first __syncthreads, which every thread reaches after these reads.
  }
}

template <int R>
void launch(const void* load0, const void* unassigned, const void* target,
            const void* home, void* sites, int B, int N, int F, int vec_ok,
            cudaStream_t stream) {
  balance_scan_kernel<R><<<B, THREADS, 0, stream>>>(
      (const int64_t*)load0, (const uint8_t*)unassigned,
      (const uint8_t*)target, (const int64_t*)home, (int64_t*)sites, N, F,
      vec_ok);
}

}  // namespace

// load0 (B, F) int64; unassigned, target (B, N) bool; home (B, N) int64
// -> sites (B, N) int64. F is at most 1024 (32 loads per lane).
extern "C" int balance_scan_launch(const void* load0, const void* unassigned,
                                   const void* target, const void* home,
                                   void* sites, int B, int N, int F,
                                   void* stream) {
  if (B < 1 || N < 1 || F < 1 || F > 32 * 32)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  // 16-byte loads and stores where a row starts on a 16-task boundary.
  const int vec_ok = (uintptr_t)unassigned % 16 == 0 &&
                     (uintptr_t)target % 16 == 0 &&
                     (uintptr_t)home % 16 == 0 && (uintptr_t)sites % 16 == 0;
  const int r = (F + 31) / 32;
  if (r <= 1) {
    launch<1>(load0, unassigned, target, home, sites, B, N, F, vec_ok, s);
  } else if (r <= 2) {
    launch<2>(load0, unassigned, target, home, sites, B, N, F, vec_ok, s);
  } else if (r <= 4) {
    launch<4>(load0, unassigned, target, home, sites, B, N, F, vec_ok, s);
  } else if (r <= 8) {
    launch<8>(load0, unassigned, target, home, sites, B, N, F, vec_ok, s);
  } else {
    launch<32>(load0, unassigned, target, home, sites, B, N, F, vec_ok, s);
  }
  return (int)cudaGetLastError();
}
