// ELARE Phase I for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/phase1_map/kernel.py
// phase1_map_padded (body _phase1_kernel): over pre-gathered per-task
// EET rows, the feasibility mask s + e <= d, the energy p_dyn * e, and the
// masked min / lowest-index argmin over machines per task.
//
// What bounds it on this card: bytes. Per task it reads an EET row
// (4 * M B), a deadline (4 B) and a flag (1 B) and writes a machine
// (8 B) and an energy (4 B). At the main path's shape (B = 150,
// N = 2000, M = 4) that is 9.9 MB, about 3 us at 3.35 TB/s, below the
// cost of one launch. Its float work is a few operations per pair.
//
// What the design does about it: one thread per (replicate, task), grid
// (ceil(N / 256), B); each thread reads its own row once and loops over M,
// and the (B, M) machine state stays in L1. No padding: the TPU wrapper
// padded machine lanes with avail = 0 and qfree = 0 so that they never
// won; here the loop stops at M, which keeps that contract.
//
// Built with -fmad=false so that p_dyn * e and s + e round as the plain
// PyTorch version does.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float BIG = 1e30f;
constexpr int THREADS = 256;

__global__ void phase1_map_kernel(
    const float* __restrict__ avail, const float* __restrict__ pdyn,
    int pdyn_bstride, const uint8_t* __restrict__ qfree,
    const float* __restrict__ eet_rows, const float* __restrict__ deadline,
    const uint8_t* __restrict__ pending, int64_t* __restrict__ best_m,
    float* __restrict__ best_ec, int N, int M) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (i >= N) return;
  const size_t t = (size_t)b * N + i;
  const bool pend = pending[t] != 0;
  const float d = deadline[t];
  const float* row = eet_rows + t * M;
  const float* s = avail + (size_t)b * M;
  const float* pd = pdyn + (size_t)b * pdyn_bstride;
  const uint8_t* qf = qfree + (size_t)b * M;
  int best = 0;
  float value = BIG;
  for (int m = 0; m < M; ++m) {
    const float e = row[m];
    const bool feas = (s[m] + e <= d) && pend && qf[m] != 0;
    const float ec = feas ? pd[m] * e : BIG;
    if (ec < value) {
      value = ec;
      best = m;
    }
  }
  best_m[t] = best;
  best_ec[t] = value;
}

}  // namespace

extern "C" int phase1_map_launch(
    const void* avail, const void* pdyn, int pdyn_bstride, const void* qfree,
    const void* eet_rows, const void* deadline, const void* pending,
    void* best_m, void* best_ec, int B, int N, int M, void* stream) {
  if (B < 1 || N < 1 || M < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + THREADS - 1) / THREADS, B);
  phase1_map_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)avail, (const float*)pdyn, pdyn_bstride,
      (const uint8_t*)qfree, (const float*)eet_rows, (const float*)deadline,
      (const uint8_t*)pending, (int64_t*)best_m, (float*)best_ec, N, M);
  return (int)cudaGetLastError();
}
