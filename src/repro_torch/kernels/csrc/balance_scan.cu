// The dispatcher's least-loaded site walk for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel src/repro/kernels/map_fused/kernel.py
// balance_scan_padded (body _balance_kernel), the fused form of
// core/dispatch/base.py sequential_balance. Per replicate, tasks are
// walked in index order carrying per-site loads:
//
//   best = argmin(load), lowest site on ties
//   s_k  = target_k ? best : home_k            (every task gets an output)
//   load[s_k] += unassigned_k                  (only new tasks count)
//
// load0 is taken as given (the caller adds any penalty, such as the dead
// site's +1,000,000), and loads are 64-bit, so the argmin is exact for
// any load. There is no padding: the kernel loops to F.
//
// What bounds it on this card. Bytes: per task it reads two flags (1 B
// each) and a home site (8 B) and writes a site (8 B). At the smoke's
// shape (B = 150 replicates, N = 4000 tasks, F = 8 sites) that is about
// 10.8 MB, 3.2 us at 3.35 TB/s. Its real limit is the serial dependence
// between new tasks: each one's site depends on every earlier new task's
// increment, which the TPU kernel walked one task per step (N steps).
//
// What the design does about it: one warp owns one replicate, and lane f
// keeps load[f] (and load[f + 32], ... for F > 32) in registers. Tasks are
// read 32 at a time, one per lane, coalesced, eight such chunks loaded
// before any is walked so that their loads are in flight together.
// __ballot_sync gives the chunk's new tasks. Between two new tasks the
// loads do not change, so every target lane in that span takes the same
// argmin; it is computed once after each new task's increment (a warp
// reduction of (load, site) pairs, lowest pair wins) and not per task.
// The serial depth is the number of new tasks plus N / 32, not N: at an
// event only the tasks admitted since the last one are new.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;        // replicates per block, one warp each
constexpr int SUB = 8;          // 32-task chunks loaded before walking
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

template <int R>
__global__ void balance_scan_kernel(const int64_t* __restrict__ load0,
                                    const uint8_t* __restrict__ unassigned,
                                    const uint8_t* __restrict__ target,
                                    const int64_t* __restrict__ home,
                                    int64_t* __restrict__ sites, int B,
                                    int N, int F) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  const size_t row = (size_t)b * N;

  long long load[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int f = 32 * i + lane;
    // Lanes past F never win: their load is the largest there is, and a
    // real site with the same load has the lower index.
    load[i] = f < F ? (long long)load0[(size_t)b * F + f] : LLONG_MAX;
  }
  int best = least_loaded(load, lane);

  for (int base = 0; base < N; base += 32 * SUB) {
    bool nw[SUB], tg[SUB];
    long long hm[SUB];
#pragma unroll
    for (int u = 0; u < SUB; ++u) {
      const int k = base + 32 * u + lane;
      const bool in = k < N;
      nw[u] = in && unassigned[row + k] != 0;
      tg[u] = in && target[row + k] != 0;
      hm[u] = in ? (long long)home[row + k] : 0;
    }
#pragma unroll
    for (int u = 0; u < SUB; ++u) {
      unsigned fresh = __ballot_sync(FULL, nw[u]);
      long long out = 0;
      int lo = 0;  // first lane of the span that sees the current loads
      while (fresh) {
        const int j = __ffs(fresh) - 1;  // the span's new task
        if (lane >= lo && lane <= j) out = tg[u] ? best : hm[u];
        const long long s = __shfl_sync(FULL, out, j);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int f = 32 * i + lane;
          if (f < F && f == s) load[i] += 1;
        }
        best = least_loaded(load, lane);
        lo = j + 1;
        fresh &= fresh - 1;
      }
      if (lane >= lo) out = tg[u] ? best : hm[u];
      const int k = base + 32 * u + lane;
      if (k < N) sites[row + k] = (int64_t)out;
    }
  }
}

template <int R>
void launch(const void* load0, const void* unassigned, const void* target,
            const void* home, void* sites, int B, int N, int F,
            cudaStream_t stream) {
  const dim3 grid((B + WARPS - 1) / WARPS);
  balance_scan_kernel<R><<<grid, 32 * WARPS, 0, stream>>>(
      (const int64_t*)load0, (const uint8_t*)unassigned,
      (const uint8_t*)target, (const int64_t*)home, (int64_t*)sites, B, N,
      F);
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
  const int r = (F + 31) / 32;
  if (r <= 1) {
    launch<1>(load0, unassigned, target, home, sites, B, N, F, s);
  } else if (r <= 2) {
    launch<2>(load0, unassigned, target, home, sites, B, N, F, s);
  } else if (r <= 4) {
    launch<4>(load0, unassigned, target, home, sites, B, N, F, s);
  } else if (r <= 8) {
    launch<8>(load0, unassigned, target, home, sites, B, N, F, s);
  } else {
    launch<32>(load0, unassigned, target, home, sites, B, N, F, s);
  }
  return (int)cudaGetLastError();
}
