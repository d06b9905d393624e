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
// deadline (4 B), a type (8 B) and two flags (1 B each) and writes one
// flag (1 B); evict_stats reads 13 B and writes 5 B. The EET table and the
// (M,) machine state are a few KB that stay in L1. At the main path's
// shape (B = 150 replicates, N = 2000 tasks, M = 4) that is 4.5 MB and
// 5.4 MB, about 1.3 us and 1.6 us at 3.35 TB/s, below the cost of one
// launch; the float work (a few dozen operations per task) is far from
// the 67 TFLOP/s float32 rate.
//
// The EET table is shared by every replicate (batch stride 0) or given
// per replicate (stride S * M): the federation hands each site view of a
// replicate its own table, with the other sites' columns cut off or set
// to BIG.
//
// What the design does about it: every task is read once, by one thread,
// with neighbouring threads on neighbouring tasks (coalesced), and nothing
// but the outputs goes back to device memory. The TPU kernel carried its
// Phase-II running argmin across a sequential grid of task tiles; here
// one CTA owns one replicate, its threads stride over the tasks, and the
// cross-task argmin is an atomicMin in shared memory on a u64 that packs
// an order-preserving image of the float key (high 32 bits) with the task
// index (low 32 bits), so the smallest key wins and ties go to the lowest
// task index, as jnp.argmin does. 2 * M slots: M = 512 takes 8 KB.
//
// Built with -fmad=false: every multiply and add rounds on its own, as
// the plain PyTorch version does, and the decisions match it bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float BIG = 1e30f;
constexpr int THREADS = 256;

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

template <int NOM, int KEY, int DROP>
__global__ void map_decide_kernel(
    const float* __restrict__ now_b, const float* __restrict__ start,
    const float* __restrict__ pdyn, int pdyn_bstride,
    const uint8_t* __restrict__ qfree, const float* __restrict__ eet,
    int eet_bstride, const float* __restrict__ deadline,
    const uint8_t* __restrict__ pending,
    const int64_t* __restrict__ task_type,
    const uint8_t* __restrict__ suffered, uint8_t* __restrict__ drop_out,
    float* __restrict__ hi_key, int64_t* __restrict__ hi_task,
    float* __restrict__ lo_key, int64_t* __restrict__ lo_task, int N, int M) {
  extern __shared__ unsigned long long slots[];  // [0, M): hi; [M, 2M): lo
  const int b = blockIdx.x;
  const float now = now_b[b];
  const float* st = start + (size_t)b * M;
  const float* pd = pdyn + (size_t)b * pdyn_bstride;
  const uint8_t* qf = qfree + (size_t)b * M;
  const float* eet_b = eet + (size_t)b * eet_bstride;
  // "no nominee": key BIG, task 0 — what the TPU kernel's accumulator
  // starts from and keeps unless a key strictly below BIG arrives.
  const unsigned long long none = (unsigned long long)order_key(BIG) << 32;
  for (int m = threadIdx.x; m < 2 * M; m += blockDim.x) slots[m] = none;
  __syncthreads();

  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const size_t t = (size_t)b * N + i;
    const bool pend = pending[t] != 0;
    const float d = deadline[t];
    const float* row = eet_b + task_type[t] * M;
    const bool stale = pend && (now >= d);
    const bool alive = pend && !stale;

    bool drop = stale;
    if (DROP == DROP_STALE_HOPELESS) {
      float min_exec = row[0];
      for (int m = 1; m < M; ++m) min_exec = fminf(min_exec, row[m]);
      drop = drop || (pend && (now + min_exec > d));
    }
    drop_out[t] = drop ? 1 : 0;

    // Phase I: nominate one machine (lowest index on ties).
    int best = 0;
    float value = BIG;
    bool valid;
    if (NOM == RANDOM_HASH) {
      const uint32_t h = (uint32_t)i * 2654435761u + (uint32_t)(now * 1e3f);
      best = (int)(h % (uint32_t)M);
      value = (float)i;
      valid = alive;
    } else {
      for (int m = 0; m < M; ++m) {
        const float e = row[m];
        const float s = st[m];
        const bool free_slot = qf[m] != 0;
        float score;
        if (NOM == MIN_ENERGY_FEASIBLE) {
          score = (s + e <= d && pend && free_slot) ? pd[m] * e : BIG;
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
      valid = value < BIG;
    }
    if (!valid) continue;

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
    const unsigned long long packed =
        ((unsigned long long)order_key(key) << 32) | (uint32_t)i;
    atomicMin(&slots[(suffered[t] ? 0 : M) + best], packed);
  }
  __syncthreads();

  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const unsigned long long h = slots[m], l = slots[M + m];
    hi_key[(size_t)b * M + m] = from_order_key((uint32_t)(h >> 32));
    hi_task[(size_t)b * M + m] = (int64_t)(h & 0xffffffffull);
    lo_key[(size_t)b * M + m] = from_order_key((uint32_t)(l >> 32));
    lo_task[(size_t)b * M + m] = (int64_t)(l & 0xffffffffull);
  }
}

__global__ void evict_stats_kernel(
    const float* __restrict__ start, const uint8_t* __restrict__ qfree,
    const float* __restrict__ eet, int eet_bstride,
    const float* __restrict__ deadline, const uint8_t* __restrict__ pending,
    const int64_t* __restrict__ task_type, uint8_t* __restrict__ feas_out,
    float* __restrict__ min_exec_out, int N, int M) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (i >= N) return;
  const size_t t = (size_t)b * N + i;
  const bool pend = pending[t] != 0;
  const float d = deadline[t];
  const float* row = eet + (size_t)b * eet_bstride + task_type[t] * M;
  const float* st = start + (size_t)b * M;
  const uint8_t* qf = qfree + (size_t)b * M;
  bool any = false;
  float min_exec = row[0];
  for (int m = 0; m < M; ++m) {
    const float e = row[m];
    any = any || (pend && qf[m] != 0 && st[m] + e <= d);
    min_exec = fminf(min_exec, e);
  }
  feas_out[t] = any ? 1 : 0;
  min_exec_out[t] = min_exec;
}

using MapDecideFn = void (*)(const float*, const float*, const float*, int,
                             const uint8_t*, const float*, int, const float*,
                             const uint8_t*, const int64_t*, const uint8_t*,
                             uint8_t*, float*, int64_t*, float*, int64_t*,
                             int, int);

template <int NOM, int KEY>
MapDecideFn by_drop(int drop) {
  return drop ? map_decide_kernel<NOM, KEY, DROP_STALE_HOPELESS>
              : map_decide_kernel<NOM, KEY, DROP_STALE>;
}

template <int NOM>
MapDecideFn by_key(int key, int drop) {
  switch (key) {
    case KEY_VALUE: return by_drop<NOM, KEY_VALUE>(drop);
    case KEY_DEADLINE: return by_drop<NOM, KEY_DEADLINE>(drop);
    case KEY_URGENCY: return by_drop<NOM, KEY_URGENCY>(drop);
    default: return by_drop<NOM, KEY_FCFS>(drop);
  }
}

MapDecideFn pick_map_decide(int nom, int key, int drop) {
  switch (nom) {
    case MIN_ENERGY_FEASIBLE: return by_key<MIN_ENERGY_FEASIBLE>(key, drop);
    case MIN_COMPLETION: return by_key<MIN_COMPLETION>(key, drop);
    case MIN_EXECUTION: return by_key<MIN_EXECUTION>(key, drop);
    default: return by_key<RANDOM_HASH>(key, drop);
  }
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
  const MapDecideFn fn = pick_map_decide(nominator, key_kind, drop_rule);
  const size_t smem = 2 * (size_t)M * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  fn<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)now, (const float*)start, (const float*)pdyn,
      pdyn_bstride, (const uint8_t*)qfree, (const float*)eet, eet_bstride,
      (const float*)deadline, (const uint8_t*)pending,
      (const int64_t*)task_type, (const uint8_t*)suffered, (uint8_t*)drop,
      (float*)hi_key, (int64_t*)hi_task, (float*)lo_key, (int64_t*)lo_task,
      N, M);
  return (int)cudaGetLastError();
}

extern "C" int evict_stats_launch(
    const void* start, const void* qfree, const void* eet, int eet_bstride,
    const void* deadline, const void* pending, const void* task_type,
    void* feas, void* min_exec, int B, int N, int M, void* stream) {
  if (B < 1 || N < 1 || M < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + THREADS - 1) / THREADS, B);
  evict_stats_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)start, (const uint8_t*)qfree, (const float*)eet,
      eet_bstride, (const float*)deadline, (const uint8_t*)pending,
      (const int64_t*)task_type, (uint8_t*)feas, (float*)min_exec, N, M);
  return (int)cudaGetLastError();
}
