// Fused per-event map decision for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels of src/repro/kernels/map_fused/kernel.py:
//   * map_decide_padded (body _map_decide_kernel): Eq. 1/2 feasibility,
//     Phase-I nomination, Phase-II key, drop rule and the per-machine
//     argmin of the key over the suffered (hi) and other (lo) nominees;
//   * evict_stats_padded (body _evict_stats_kernel): per task, feasible
//     now on some free machine, and the fastest EET.
//
// What bounds them on this card: bytes. Per task map_decide reads a
// deadline (4 B), an int32 type (4 B) and two flags (1 B each) and writes
// one flag (1 B); evict_stats reads 9 B and writes 5 B. The EET table and
// the (M,) machine state are a few KB that stay in L1. At the main path's
// shape (B = 150 replicates, N = 2000 tasks, M = 4) that is 3.3 MB and
// 4.2 MB, about 1.0 us and 1.3 us at 3.35 TB/s, below the cost of one
// launch; the float work (a few dozen operations per task) is far from
// the 67 TFLOP/s float32 rate.
//
// The EET table is shared by every replicate (batch stride 0) or given
// per replicate (stride S * M): the federation hands each site view of a
// replicate its own table, with the other sites' columns cut off or set
// to BIG.
//
// What the design does about it: every task is read once, with
// neighbouring threads on neighbouring tasks (coalesced), and nothing but
// the outputs goes back to device memory. The TPU kernel carried its
// Phase-II running argmin across a sequential grid of task tiles; here
// the argmin is a min over u64s that pack an order-preserving image of the
// float key (high 32 bits) with the task index (low 32 bits), so the
// smallest key wins and ties go to the lowest task index, as jnp.argmin
// does, whatever order the tasks are met in.
//
// map_decide:
// * Each thread takes 4 tasks at a time: a float4 of deadlines, uchar4s of
//   the pending and suffered flags, an int4 of types, and one uchar4 store
//   of the drop flags; the few tasks before the row's first 16-byte
//   boundary and after its last go one by one.
// * For M <= 8 (the template parameter MS = 4 or 8 bounds M) each thread
//   keeps its running minimum per (pool, machine) slot in registers across
//   all its tasks (a 32-bit order key and the task: a thread meets its
//   tasks in increasing index order, so a strictly lower key replaces),
//   with the machine state (start, power, free slot) in registers too.
//   Warp shuffles merge a warp's minima as packed u64s, one shared-memory
//   write per warp and slot follows, and the block merges its warps: no
//   atomic per task (the SASS of these instances holds no ATOMS).
// * Above 8 machines each valid task does a shared-memory atomicMin on one
//   of the 2 M slots (M = 512 takes 8 KB).
// * Fewer than 2 x 132 rows leave SMs idle, so a row is then split over a
//   cluster of 2 or 4 blocks (the fewest that give 2 x 132 blocks, 4 at
//   most): thread u of block r takes the row's task groups q with q mod
//   (size x 128) = 128 r + u, and likewise the single tasks before and
//   after them, and block 0 merges the cluster's slots through
//   distributed shared memory in the same launch.
// evict_stats:
// * Both outputs depend on a task only through (type, deadline, pending).
//   So each block first builds, for every type s of its row, in shared
//   memory: min_exec[s] = min_m e[s][m], T[s] = min over free m of
//   (start[m] + e[s][m]) and the flag any_free[s], one warp per type, its
//   lanes over the machines and a shuffle reduction across them. Then
//   feas = pending && any_free[type] && T[type] <= d, with no loop over
//   machines per task. That equals the plain version's any_m(free &&
//   start + e <= d) bit for bit: each sum rounds as there, and a minimum
//   adds no rounding in any order. any_free stays its own flag (an
//   infinite T would read true for a task whose deadline is +inf).
// * Each thread takes 4 tasks at a time: a float4 of deadlines, an int4 of
//   types and a uchar4 of pending flags in, a uchar4 of feas flags and a
//   float4 of min_exec out; the tasks before the row's first 16-byte
//   boundary and after its last go one by one. A row is split over as
//   many blocks as fill the card twice over (at most one group of 4 per
//   thread and block), each of which builds the row's tables itself.
//
// Built with -fmad=false: every multiply and add rounds on its own, as
// the plain PyTorch version does, and the decisions match it bit for bit.
#include <cmath>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr float BIG = 1e30f;
constexpr int THREADS = 128;  // map_decide: 128 measured faster than 256
constexpr int WARPS = THREADS / 32;
constexpr int EVICT_THREADS = 256;
// evict_stats splits rows until the grid holds this many blocks per SM.
constexpr int EVICT_BLOCKS_PER_SM = 4;
constexpr unsigned FULL = 0xffffffffu;
// Below this many rows a row is split over a cluster (2 blocks per SM).
constexpr int SPLIT_BELOW_ROWS = 2 * 132;

enum Nominator { MIN_ENERGY_FEASIBLE = 0, MIN_COMPLETION = 1,
                 MIN_EXECUTION = 2, RANDOM_HASH = 3 };
enum KeyKind { KEY_VALUE = 0, KEY_DEADLINE = 1, KEY_URGENCY = 2,
               KEY_FCFS = 3 };
enum DropRule { DROP_STALE = 0, DROP_STALE_HOPELESS = 1 };

// Order-preserving float -> uint32 map (negative keys included). -0.0 is
// folded onto +0.0 first: jnp's < treats them as equal.
__device__ __forceinline__ uint32_t order_key(float f) {
  uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) == 0u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_key(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// A row's machine state: in registers for MS > 0 (M <= MS), else read
// where it lies.
template <int MS>
struct Machines {
  float st[MS], pd[MS];
  bool qf[MS];
  __device__ __forceinline__ Machines(const float* s, const float* p,
                                      const uint8_t* q, int M) {
#pragma unroll
    for (int m = 0; m < MS; ++m) {
      st[m] = pd[m] = 0.f;
      qf[m] = false;
      if (m < M) {
        st[m] = s[m];
        pd[m] = p[m];
        qf[m] = q[m] != 0;
      }
    }
  }
  __device__ __forceinline__ float start(int m) const { return st[m]; }
  __device__ __forceinline__ float power(int m) const { return pd[m]; }
  __device__ __forceinline__ bool free_slot(int m) const { return qf[m]; }
};
template <>
struct Machines<0> {
  const float* st;
  const float* pd;
  const uint8_t* qf;
  __device__ __forceinline__ Machines(const float* s, const float* p,
                                      const uint8_t* q, int)
      : st(s), pd(p), qf(q) {}
  __device__ __forceinline__ float start(int m) const { return st[m]; }
  __device__ __forceinline__ float power(int m) const { return pd[m]; }
  __device__ __forceinline__ bool free_slot(int m) const { return qf[m] != 0; }
};

struct Decision {
  bool drop, valid;
  int best;
  uint32_t okey;  // order_key of the Phase-II key
};

// One task's drop flag, Phase-I nominee and the order key of its Phase-II
// key (i is the
// task's index in its row).
template <int NOM, int KEY, int DROP, int MS>
__device__ __forceinline__ Decision decide(int i, float d, bool pend,
                                           int type, float now,
                                           const Machines<MS>& mc,
                                           const float* __restrict__ eet_b,
                                           int M) {
  const float* row = eet_b + type * M;
  const int mend = MS ? MS : M;
  const bool stale = pend && (now >= d);
  const bool alive = pend && !stale;
  Decision out;

  bool drop = stale;
  if (DROP == DROP_STALE_HOPELESS) {
    float min_exec = row[0];
#pragma unroll
    for (int m = 1; m < mend; ++m) {
      if (m >= M) break;
      min_exec = fminf(min_exec, row[m]);
    }
    drop = drop || (pend && (now + min_exec > d));
  }
  out.drop = drop;

  // Phase I: nominate one machine (lowest index on ties).
  int best = 0;
  float value = BIG;
  if (NOM == RANDOM_HASH) {
    const uint32_t h = (uint32_t)i * 2654435761u + (uint32_t)(now * 1e3f);
    best = (int)(h % (uint32_t)M);
    value = (float)i;
    out.valid = alive;
  } else {
#pragma unroll
    for (int m = 0; m < mend; ++m) {
      if (m >= M) break;
      const float e = row[m];
      const float s = mc.start(m);
      const bool free_slot = mc.free_slot(m);
      float score;
      if (NOM == MIN_ENERGY_FEASIBLE) {
        score = (s + e <= d && pend && free_slot) ? mc.power(m) * e : BIG;
      } else if (NOM == MIN_COMPLETION) {
        const float c = (s + e <= d) ? s + e : ((s < d) ? d : s);
        score = (alive && free_slot) ? c : BIG;
      } else {  // MIN_EXECUTION
        score = (alive && free_slot) ? e : BIG;
      }
      if (score < value) {
        value = score;
        best = m;
      }
    }
    out.valid = value < BIG;
  }
  out.best = best;

  // Phase II key (lower = better).
  float key;
  if (KEY == KEY_VALUE) {
    key = value;
  } else if (KEY == KEY_DEADLINE) {
    key = d + 1e-6f * value;
  } else if (KEY == KEY_URGENCY) {
    const float slack = d - now - row[best];
    key = -(1.0f / (fabsf(slack) < 1e-9f ? 1e-9f : slack));
  } else {  // KEY_FCFS
    key = (float)i;
  }
  out.okey = order_key(key);
  return out;
}

__device__ __forceinline__ unsigned long long umin(unsigned long long a,
                                                   unsigned long long b) {
  return a < b ? a : b;
}

// A thread's running minima (MS > 0): slot k of 2 MS, [0, MS) suffered and
// [MS, 2 MS) other, takes the task's order key when it is strictly lower.
// A thread meets its tasks in increasing index order, so on equal keys
// the lower index stays, as the packed u64 minimum would have it.
template <int MS>
__device__ __forceinline__ void take(uint32_t (&key)[2 * MS],
                                     uint32_t (&task)[2 * MS], int k,
                                     uint32_t okey, uint32_t i) {
#pragma unroll
  for (int s = 0; s < 2 * MS; ++s) {
    const bool lower = s == k && okey < key[s];
    key[s] = lower ? okey : key[s];
    task[s] = lower ? i : task[s];
  }
}

template <int NOM, int KEY, int DROP, int MS>
__global__ void __launch_bounds__(THREADS) map_decide_kernel(
    const float* __restrict__ now_b, const float* __restrict__ start,
    const float* __restrict__ pdyn, int pdyn_bstride,
    const uint8_t* __restrict__ qfree, const float* __restrict__ eet,
    int eet_bstride, const float* __restrict__ deadline,
    const uint8_t* __restrict__ pending,
    const int32_t* __restrict__ task_type,
    const uint8_t* __restrict__ suffered, uint8_t* __restrict__ drop_out,
    float* __restrict__ hi_key, int64_t* __restrict__ hi_task,
    float* __restrict__ lo_key, int64_t* __restrict__ lo_task, int N, int M,
    int csize, int vec) {
  constexpr int SL = MS ? MS : 1;  // slots per pool held per thread
  extern __shared__ unsigned long long dyn_slots[];  // MS == 0: [2 M]
  __shared__ unsigned long long warp_slots[MS ? WARPS * 2 * SL : 1];
  __shared__ unsigned long long block_slots[MS ? 2 * SL : 1];
  const int part = (int)(blockIdx.x % csize);  // rank in the cluster
  const int b = (int)(blockIdx.x / csize);
  const int tid = threadIdx.x;
  const float now = now_b[b];
  const Machines<MS> mc(start + (size_t)b * M, pdyn + (size_t)b * pdyn_bstride,
                        qfree + (size_t)b * M, M);
  const float* eet_b = eet + (size_t)b * eet_bstride;
  const int pool = MS ? MS : M;  // slot of machine m in the other pool
  // Every slot starts as "no nominee": key BIG, task 0 — what the TPU
  // kernel's accumulator starts from and keeps unless a key strictly below
  // BIG arrives.
  uint32_t skey[2 * SL], stask[2 * SL];
#pragma unroll
  for (int s = 0; s < 2 * SL; ++s) {
    skey[s] = order_key(BIG);
    stask[s] = 0;
  }
  unsigned long long* slots = MS ? block_slots : dyn_slots;
  if constexpr (MS == 0) {
    const unsigned long long none = (unsigned long long)order_key(BIG) << 32;
    for (int s = tid; s < 2 * M; s += THREADS) dyn_slots[s] = none;
    __syncthreads();
  }

  auto one = [&](int i, float d, bool pend, int type, bool suff) {
    const Decision r = decide<NOM, KEY, DROP, MS>(i, d, pend, type, now, mc,
                                                  eet_b, M);
    if (r.valid) {
      const int k = (suff ? 0 : pool) + r.best;
      if constexpr (MS > 0)
        take<SL>(skey, stask, k, r.okey, (uint32_t)i);
      else
        atomicMin(&dyn_slots[k],
                  ((unsigned long long)r.okey << 32) | (uint32_t)i);
    }
    return r.drop;
  };

  // The row's tasks: groups of 4 from its first 16-byte boundary (flat
  // index a multiple of 4) to its last, the rest one by one; each thread
  // meets its tasks in increasing index order (head, groups, tail).
  const size_t base = (size_t)b * N, end = base + N;
  size_t a0 = end, a1 = end;  // the groups of 4 span [a0, a1)
  if (vec) {
    const size_t up = (base + 3) & ~(size_t)3, down = end & ~(size_t)3;
    a0 = up < end ? up : end;
    a1 = down > a0 ? down : a0;
  }
  const int head = (int)(a0 - base);
  const int n_quad = (int)((a1 - a0) / 4);
  const int gid = part * THREADS + tid, gstride = csize * THREADS;
  auto single = [&](int i) {
    const size_t t = base + i;
    drop_out[t] = one(i, deadline[t], pending[t] != 0, task_type[t],
                      suffered[t] != 0) ? 1 : 0;
  };
  for (int k = gid; k < head; k += gstride) single(k);
  for (int q = gid; q < n_quad; q += gstride) {
    const size_t t = a0 + 4 * (size_t)q;
    const int i = (int)(t - base);
    const float4 d4 = __ldg(reinterpret_cast<const float4*>(deadline + t));
    const uchar4 p4 = __ldg(reinterpret_cast<const uchar4*>(pending + t));
    const uchar4 s4 = __ldg(reinterpret_cast<const uchar4*>(suffered + t));
    const int4 y4 = __ldg(reinterpret_cast<const int4*>(task_type + t));
    uchar4 o;
    o.x = one(i, d4.x, p4.x != 0, y4.x, s4.x != 0) ? 1 : 0;
    o.y = one(i + 1, d4.y, p4.y != 0, y4.y, s4.y != 0) ? 1 : 0;
    o.z = one(i + 2, d4.z, p4.z != 0, y4.z, s4.z != 0) ? 1 : 0;
    o.w = one(i + 3, d4.w, p4.w != 0, y4.w, s4.w != 0) ? 1 : 0;
    *reinterpret_cast<uchar4*>(drop_out + t) = o;
  }
  for (int k = (int)(a1 - base) + gid; k < N; k += gstride) single(k);

  const int nslots = 2 * pool;
  if constexpr (MS > 0) {
    // Merge the warp's minima by shuffles, then the block's warps.
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int s = 0; s < 2 * SL; ++s) {
      unsigned long long v = ((unsigned long long)skey[s] << 32) | stask[s];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v = umin(v, __shfl_xor_sync(FULL, v, off));
      if (lane == 0) warp_slots[warp * 2 * SL + s] = v;
    }
    __syncthreads();
    if (tid < nslots) {
      unsigned long long v = warp_slots[tid];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) v = umin(v, warp_slots[w * 2 * SL + tid]);
      block_slots[tid] = v;
    }
  }
  __syncthreads();

  // Block 0 of the cluster merges the cluster's slots (distributed shared
  // memory) and writes the row's argmins.
  auto emit = [&](int s, unsigned long long v) {
    const bool hi = s < pool;
    const int m = hi ? s : s - pool;
    if (m >= M) return;
    const size_t o = (size_t)b * M + m;
    (hi ? hi_key : lo_key)[o] = from_order_key((uint32_t)(v >> 32));
    (hi ? hi_task : lo_task)[o] = (int64_t)(v & 0xffffffffull);
  };
  if (csize > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (part == 0) {
      for (int s = tid; s < nslots; s += THREADS) {
        unsigned long long v = slots[s];
        for (int r = 1; r < csize; ++r)
          v = umin(v, *cluster.map_shared_rank(slots + s, r));
        emit(s, v);
      }
    }
    cluster.sync();  // the other blocks' slots stay until block 0 is done
  } else {
    for (int s = tid; s < nslots; s += THREADS) emit(s, slots[s]);
  }
}

// Per type of one row, what evict_stats reads for each task of that type.
struct TypeStats {
  float min_exec;  // fastest EET over the row's machines
  float reach;     // min over free machines of start + e (valid if any_free)
};

__global__ void __launch_bounds__(EVICT_THREADS) evict_stats_kernel(
    const float* __restrict__ start, const uint8_t* __restrict__ qfree,
    const float* __restrict__ eet, int eet_bstride,
    const float* __restrict__ deadline, const uint8_t* __restrict__ pending,
    const int32_t* __restrict__ task_type, uint8_t* __restrict__ feas_out,
    float* __restrict__ min_exec_out, int N, int M, int S, int split,
    int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  TypeStats* stats = reinterpret_cast<TypeStats*>(smem);
  uint8_t* any_free = smem + (size_t)S * sizeof(TypeStats);
  const int part = (int)(blockIdx.x % split);
  const int b = (int)(blockIdx.x / split);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // The row's per-type tables: warp w takes types w, w + 8, ..., its
  // lanes machines lane, lane + 32, ... (+inf is the minima's identity;
  // any_free says whether reach is real).
  const float* eet_b = eet + (size_t)b * eet_bstride;
  const float* st = start + (size_t)b * M;
  const uint8_t* qf = qfree + (size_t)b * M;
  for (int s = warp; s < S; s += EVICT_THREADS / 32) {
    const float* row = eet_b + (size_t)s * M;
    float mn = INFINITY, reach = INFINITY;
    bool any = false;
    for (int m = lane; m < M; m += 32) {
      const float e = row[m];
      mn = fminf(mn, e);
      if (qf[m] != 0) {
        reach = fminf(reach, st[m] + e);
        any = true;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mn = fminf(mn, __shfl_xor_sync(FULL, mn, off));
      reach = fminf(reach, __shfl_xor_sync(FULL, reach, off));
    }
    any = __any_sync(FULL, any);
    if (lane == 0) {
      stats[s] = TypeStats{mn, reach};
      any_free[s] = any ? 1 : 0;
    }
  }
  __syncthreads();

  auto one = [&](float d, bool pend, int type, float& mn) -> uint8_t {
    const TypeStats ts = stats[type];
    mn = ts.min_exec;
    return pend && any_free[type] != 0 && ts.reach <= d ? 1 : 0;
  };

  // The row's tasks: groups of 4 from its first 16-byte boundary to its
  // last, the rest one by one, spread over the row's blocks.
  const size_t base = (size_t)b * N, end = base + N;
  size_t a0 = end, a1 = end;  // the groups of 4 span [a0, a1)
  if (vec) {
    const size_t up = (base + 3) & ~(size_t)3, down = end & ~(size_t)3;
    a0 = up < end ? up : end;
    a1 = down > a0 ? down : a0;
  }
  const int head = (int)(a0 - base);
  const int n_quad = (int)((a1 - a0) / 4);
  const int gid = part * EVICT_THREADS + tid, gstride = split * EVICT_THREADS;
  auto single = [&](size_t t) {
    float mn;
    feas_out[t] = one(deadline[t], pending[t] != 0, task_type[t], mn);
    min_exec_out[t] = mn;
  };
  for (int k = gid; k < head; k += gstride) single(base + k);
  for (int q = gid; q < n_quad; q += gstride) {
    const size_t t = a0 + 4 * (size_t)q;
    const float4 d4 = __ldg(reinterpret_cast<const float4*>(deadline + t));
    const int4 y4 = __ldg(reinterpret_cast<const int4*>(task_type + t));
    const uchar4 p4 = __ldg(reinterpret_cast<const uchar4*>(pending + t));
    uchar4 f;
    float4 mn;
    f.x = one(d4.x, p4.x != 0, y4.x, mn.x);
    f.y = one(d4.y, p4.y != 0, y4.y, mn.y);
    f.z = one(d4.z, p4.z != 0, y4.z, mn.z);
    f.w = one(d4.w, p4.w != 0, y4.w, mn.w);
    *reinterpret_cast<uchar4*>(feas_out + t) = f;
    *reinterpret_cast<float4*>(min_exec_out + t) = mn;
  }
  for (int k = (int)(a1 - base) + gid; k < N; k += gstride) single(base + k);
}

using MapDecideFn = void (*)(const float*, const float*, const float*, int,
                             const uint8_t*, const float*, int, const float*,
                             const uint8_t*, const int32_t*, const uint8_t*,
                             uint8_t*, float*, int64_t*, float*, int64_t*,
                             int, int, int, int);

template <int NOM, int KEY, int DROP>
MapDecideFn by_slots(int M) {
  if (M <= 4) return map_decide_kernel<NOM, KEY, DROP, 4>;
  if (M <= 8) return map_decide_kernel<NOM, KEY, DROP, 8>;
  return map_decide_kernel<NOM, KEY, DROP, 0>;
}

template <int NOM, int KEY>
MapDecideFn by_drop(int drop, int M) {
  return drop ? by_slots<NOM, KEY, DROP_STALE_HOPELESS>(M)
              : by_slots<NOM, KEY, DROP_STALE>(M);
}

template <int NOM>
MapDecideFn by_key(int key, int drop, int M) {
  switch (key) {
    case KEY_VALUE: return by_drop<NOM, KEY_VALUE>(drop, M);
    case KEY_DEADLINE: return by_drop<NOM, KEY_DEADLINE>(drop, M);
    case KEY_URGENCY: return by_drop<NOM, KEY_URGENCY>(drop, M);
    default: return by_drop<NOM, KEY_FCFS>(drop, M);
  }
}

MapDecideFn pick_map_decide(int nom, int key, int drop, int M) {
  switch (nom) {
    case MIN_ENERGY_FEASIBLE:
      return by_key<MIN_ENERGY_FEASIBLE>(key, drop, M);
    case MIN_COMPLETION: return by_key<MIN_COMPLETION>(key, drop, M);
    case MIN_EXECUTION: return by_key<MIN_EXECUTION>(key, drop, M);
    default: return by_key<RANDOM_HASH>(key, drop, M);
  }
}

// Blocks per row: 1 from 2 x 132 rows up, else the fewest of 2 and 4 that
// give 2 x 132 blocks (4 at most).
int cluster_size(int B) {
  if (B >= SPLIT_BELOW_ROWS) return 1;
  return B * 2 >= SPLIT_BELOW_ROWS ? 2 : 4;
}

}  // namespace

extern "C" int map_decide_launch(
    const void* now, const void* start, const void* pdyn, int pdyn_bstride,
    const void* qfree, const void* eet, int eet_bstride,
    const void* deadline, const void* pending, const void* task_type,
    const void* suffered, void* drop, void* hi_key, void* hi_task,
    void* lo_key, void* lo_task, int B, int N, int M, int nominator,
    int key_kind, int drop_rule, void* stream) {
  if (nominator < 0 || nominator > 3 || key_kind < 0 || key_kind > 3 ||
      drop_rule < 0 || drop_rule > 1 || B < 1 || N < 1 || M < 1)
    return (int)cudaErrorInvalidValue;
  const MapDecideFn fn = pick_map_decide(nominator, key_kind, drop_rule, M);
  const size_t smem = M > 8 ? 2 * (size_t)M * sizeof(unsigned long long) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // Groups of 4 tasks need 16-byte deadlines and types and 4-byte flags
  // where the row's flat index is a multiple of 4.
  const int vec = (uintptr_t)deadline % 16 == 0 &&
                  (uintptr_t)task_type % 16 == 0 &&
                  (uintptr_t)pending % 4 == 0 &&
                  (uintptr_t)suffered % 4 == 0 && (uintptr_t)drop % 4 == 0;
  const int csize = cluster_size(B);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * csize);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = csize > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, fn, (const float*)now, (const float*)start, (const float*)pdyn,
      pdyn_bstride, (const uint8_t*)qfree, (const float*)eet, eet_bstride,
      (const float*)deadline, (const uint8_t*)pending,
      (const int32_t*)task_type, (const uint8_t*)suffered, (uint8_t*)drop,
      (float*)hi_key, (int64_t*)hi_task, (float*)lo_key, (int64_t*)lo_task,
      N, M, csize, vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// start, qfree (B, M); eet (S, M) or per row (B, S, M) (eet_bstride 0 or
// S * M); deadline, pending, task_type (B, N), task_type int32 in [0, S)
// -> feas (B, N) bool, min_exec (B, N) f32.
extern "C" int evict_stats_launch(
    const void* start, const void* qfree, const void* eet, int eet_bstride,
    const void* deadline, const void* pending, const void* task_type,
    void* feas, void* min_exec, int B, int N, int M, int S, void* stream) {
  if (B < 1 || N < 1 || M < 1 || S < 1) return (int)cudaErrorInvalidValue;
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = (size_t)S * (sizeof(TypeStats) + 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        evict_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // Blocks per row: enough for EVICT_BLOCKS_PER_SM per SM, no more than
  // the row's groups of 4 fill with one group per thread.
  const long long want = ((long long)EVICT_BLOCKS_PER_SM * n_sm + B - 1) / B;
  const long long most = ((N + 3) / 4 + EVICT_THREADS - 1) / EVICT_THREADS;
  const int split = (int)(want < most ? want : most);
  const int vec = (uintptr_t)deadline % 16 == 0 &&
                  (uintptr_t)task_type % 16 == 0 &&
                  (uintptr_t)pending % 4 == 0 && (uintptr_t)feas % 4 == 0 &&
                  (uintptr_t)min_exec % 16 == 0;
  evict_stats_kernel<<<(unsigned)((long long)B * split), EVICT_THREADS, smem,
                       (cudaStream_t)stream>>>(
      (const float*)start, (const uint8_t*)qfree, (const float*)eet,
      eet_bstride, (const float*)deadline, (const uint8_t*)pending,
      (const int32_t*)task_type, (uint8_t*)feas, (float*)min_exec, N, M, S,
      split, vec);
  return (int)cudaGetLastError();
}
