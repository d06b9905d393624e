// Blockwise online-softmax attention (FlashAttention) for Hopper (sm_90a),
// plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// flash_attention_bhsd (body _flash_kernel). Per (batch b, query head h),
// with key/value head h / (H / Hkv):
//
//   s_ij = (q_i * hd^-0.5) . k_j                 fp32, scale before product
//   s_ij = -1e30 unless j < kv_len[b] and (not causal or q_offset + i >= j)
//   out_i = sum_j exp(s_ij - m_i) v_j / max(sum_j exp(s_ij - m_i), 1e-30)
//
// with the running max m and sum l carried over key blocks as in the TPU
// kernel. The inputs are read in the model layout (B, S, H, hd) through
// their strides, float32 or bfloat16, and all arithmetic is float32. No
// padding: keys past Sk take no part at all and query rows past Sq are not
// stored. Key blocks that every row of the tile masks (past kv_len, or
// above the causal diagonal) are skipped when kv_len >= 1: every row then
// has key 0 valid, so a skipped key would have added exp(-1e30 - m) = 0.
//
// What bounds it on this card. Operations: at the serve path's prefill
// (B = 8, H = 32, Sq = Sk = 1024, hd = 80, causal) it does about 4 B H
// Sq Sk hd / 2 = 43 GFLOP against 6.3 MB of q, k, v and out, so it is far
// above the card's ridge point; the bound is the tensor cores' rate. This
// first kernel does its products on the float32 CUDA cores, from shared
// memory, so it cannot reach that bound: moving the two products to
// wgmma is later work.
//
// What the design does: one block of 8 warps takes 64 query rows of one
// (b, h), 8 rows per warp, and walks the key blocks of 64. Q (pre-scaled)
// and each K and V block are staged in shared memory as float32, K rows at
// an odd stride so that the 32 lanes, each on its own key, hit 32 banks.
// Each lane scores 2 keys for its warp's 8 rows, the warp reduces the row
// max and sum with shuffles, writes its P rows to shared memory, and each
// lane accumulates out dims lane, lane + 32, ... of its 8 rows in
// registers (DCH = ceil(hd / 32) per row). Explicit fmaf keeps the
// products fused although the library is built with -fmad=false.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per block step
constexpr int WARPS = 8;
constexpr int ROWS = BQ / WARPS;  // rows per warp
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

struct Strides {
  long long b, s, h;
};

template <typename T, int DCH>
__global__ void __launch_bounds__(WARPS * 32)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const int* __restrict__ kv_len, T* __restrict__ o,
                           int H, int Hkv, int Sq, int Sk, int hd,
                           Strides qs, Strides ks, Strides vs, Strides os,
                           int causal, int q_offset, float scale) {
  extern __shared__ float smem[];
  const int kstride = hd | 1;  // odd: lanes on different keys, other banks
  float* Qs = smem;                       // [BQ][hd]
  float* Ks = Qs + BQ * hd;               // [BK][kstride]
  float* Vs = Ks + BK * kstride;          // [BK][hd]
  float* Ps = Vs + BK * hd;               // [WARPS][ROWS][BK]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int e = tid; e < BQ * hd; e += WARPS * 32) {
    const int r = e / hd, d = e - r * hd;
    const int i = q0 + r;
    Qs[e] = i < Sq ? to_f(qb[i * qs.s + d]) * scale : 0.f;
  }

  const int kvl = kv_len ? kv_len[b] : Sk;
  const int q_last = min(q0 + BQ, Sq) - 1;
  int kend = Sk;
  if (kvl >= 1) {
    kend = min(kend, kvl);
    if (causal) kend = min(kend, q_offset + q_last + 1);
  }

  float m[ROWS], l[ROWS], acc[ROWS][DCH];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DCH; ++c) acc[r][c] = 0.f;
  }
  float* P = Ps + warp * ROWS * BK;
  const int row0 = warp * ROWS;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous block's K, V and P reads are done
    for (int e = tid; e < BK * hd; e += WARPS * 32) {
      const int j = e / hd, d = e - j * hd;
      const int kp = k0 + j;
      const bool in = kp < Sk;
      Ks[j * kstride + d] = in ? to_f(kb[kp * ks.s + d]) : 0.f;
      Vs[e] = in ? to_f(vb[kp * vs.s + d]) : 0.f;
    }
    __syncthreads();

    // Scores of this warp's rows against keys lane and lane + 32.
    float s[ROWS][2];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r][0] = s[r][1] = 0.f;
    const float* k_a = Ks + lane * kstride;
    const float* k_b = Ks + (lane + 32) * kstride;
    for (int d = 0; d < hd; ++d) {
      const float ka = k_a[d], kbv = k_b[d];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float qv = Qs[(row0 + r) * hd + d];
        s[r][0] = fmaf(qv, ka, s[r][0]);
        s[r][1] = fmaf(qv, kbv, s[r][1]);
      }
    }

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qpos = q_offset + q0 + row0 + r;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int kp = k0 + lane + 32 * t;
        const bool valid = kp < kvl && (!causal || qpos >= kp);
        // A masked key scores -1e30 as on the TPU; a key past Sk is out.
        s[r][t] = kp >= Sk ? -INFINITY : (valid ? s[r][t] : NEG_INF);
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float p0 = expf(s[r][0] - m_new);
      const float p1 = expf(s[r][1] - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DCH; ++c) acc[r][c] *= alpha;
      P[r * BK + lane] = p0;
      P[r * BK + lane + 32] = p1;
    }
    __syncwarp();

    const int jmax = min(BK, Sk - k0);
    for (int j = 0; j < jmax; ++j) {
      float vd[DCH];
#pragma unroll
      for (int c = 0; c < DCH; ++c) {
        const int d = lane + 32 * c;
        vd[c] = d < hd ? Vs[j * hd + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float p = P[r * BK + j];
#pragma unroll
        for (int c = 0; c < DCH; ++c) acc[r][c] = fmaf(p, vd[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int i = q0 + row0 + r;
    if (i >= Sq) continue;
    const float inv = fmaxf(l[r], 1e-30f);
    T* orow = o + b * os.b + i * os.s + h * os.h;
#pragma unroll
    for (int c = 0; c < DCH; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) orow[d] = from_f<T>(acc[r][c] / inv);
    }
  }
}

template <typename T, int DCH>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           void* o, int B, int H, int Hkv, int Sq, int Sk, int hd,
           Strides qs, Strides ks, Strides vs, Strides os, int causal,
           int q_offset, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)BQ * hd + (size_t)BK * (hd | 1) +
                       (size_t)BK * hd + (size_t)WARPS * ROWS * BK);
  auto kern = flash_attention_kernel<T, DCH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, WARPS * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, kv_len, (T*)o, H, Hkv, Sq, Sk,
      hd, qs, ks, vs, os, causal, q_offset,
      (float)std::pow((double)hd, -0.5));  // as the reference's hd ** -0.5
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* kv_len,
             void* o, int B, int H, int Hkv, int Sq, int Sk, int hd,
             Strides qs, Strides ks, Strides vs, Strides os, int causal,
             int q_offset, cudaStream_t s) {
  switch ((hd + 31) / 32) {
#define CASE(n)                                                             \
  case n:                                                                   \
    return launch<T, n>(q, k, v, kv_len, o, B, H, Hkv, Sq, Sk, hd, qs, ks, \
                        vs, os, causal, q_offset, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, H, hd), k and v (B, Sk, Hkv, hd), out (B, Sq, H, hd), all of
// dtype 0 = float32 or 1 = bfloat16, read through the given element
// strides of their first three dims (the last dim has stride 1); kv_len
// (B,) int32, or null for every key valid. hd is at most 256.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, const void* kv_len, void* o,
    int B, int H, int Hkv, int Sq, int Sk, int hd, int dtype, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb, long long oss,
    long long osh, int causal, int q_offset, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || Sq < 1 || Sk < 1 || hd < 1 ||
      hd > 256 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  const cudaStream_t s = (cudaStream_t)stream;
  const int* kl = (const int*)kv_len;
  if (dtype == 0)
    return dispatch<float>(q, k, v, kl, o, B, H, Hkv, Sq, Sk, hd, qs, ks, vs,
                           os, causal, q_offset, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, kl, o, B, H, Hkv, Sq, Sk, hd, qs,
                                   ks, vs, os, causal, q_offset, s);
  return (int)cudaErrorInvalidValue;
}
