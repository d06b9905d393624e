// Single-token decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py
// decode_attention_bhd (body _decode_kernel). Per (batch b, head h), one
// query row against the first kv_len[b] rows of the cache, key/value head
// h / (H / Hkv):
//
//   s_j   = (q * hd^-0.5) . k_j,  -1e30 for j >= kv_len[b]
//   out   = sum_j exp(s_j - m) v_j / max(sum_j exp(s_j - m), 1e-30)
//
// with the running max m and sum l carried over key blocks, float32
// throughout, inputs float32 or bfloat16 in the model layout (B, S, H, hd)
// read through their strides. Keys past Sk take no part. Key blocks at or
// past kv_len are skipped when kv_len >= 1 (key 0 is then valid and a
// skipped key would add exp(-1e30 - m) = 0); with kv_len <= 0 every key
// scores -1e30 and the result is the mean of V, as on the TPU.
//
// What bounds it on this card: bytes. Each call reads kv_len rows of K
// and V per (b, kv head), 2 kv_len hd elements, and does 4 hd operations
// per row, one operation per byte in bfloat16. At the serve path's decode
// (B = 8, 32 heads, hd = 80, kv_len 1025-1088, bfloat16) that is 84-89
// MB per call, 25-27 us at 3.35 TB/s.
//
// What the design does: one block of 128 threads per (b, h), 256 blocks at
// that shape. The query row is staged in shared memory, pre-scaled; each
// step stages 128 keys of K (rows at an odd stride, conflict-free), thread
// t scores key t, the block reduces the max and sum through shuffles and
// shared memory, then V's rows replace K's and thread t accumulates dims t
// and t + 128 (DPT = ceil(hd / 128)). GQA heads of one kv head each read
// it again (through L2); sharing it, and splitting long caches over
// several blocks, is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int BK = THREADS;     // keys per block step, one per thread
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

template <typename T, int DPT>
__global__ void __launch_bounds__(THREADS)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ kv_len,
                            T* __restrict__ o, int H, int Hkv, int Sk, int hd,
                            Strides qs, Strides ks, Strides vs, Strides os,
                            float scale) {
  extern __shared__ float smem[];
  const int kstride = hd | 1;
  float* qsm = smem;                   // [hd]
  float* KV = qsm + hd;                // [BK][kstride], K then V
  float* ps = KV + BK * kstride;       // [BK]
  float* red = ps + BK;                // [2 * WARPS]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hk = h / (H / Hkv);
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int d = tid; d < hd; d += THREADS)
    qsm[d] = to_f(q[b * qs.b + h * qs.h + d]) * scale;

  const int kvl = kv_len[b];
  const int kend = kvl >= 1 ? min(kvl, Sk) : Sk;
  float m = NEG_INF, l = 0.f, acc[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) acc[c] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous step's V and ps reads are done
    for (int e = tid; e < BK * hd; e += THREADS) {
      const int j = e / hd, d = e - j * hd;
      const int kp = k0 + j;
      KV[j * kstride + d] = kp < Sk ? to_f(kb[kp * ks.s + d]) : 0.f;
    }
    __syncthreads();

    const int kp = k0 + tid;
    float s;
    if (kp >= Sk) {
      s = -INFINITY;  // past the cache: takes no part
    } else if (kp >= kvl) {
      s = NEG_INF;    // masked, as on the TPU
    } else {
      s = 0.f;
      const float* kr = KV + tid * kstride;
      for (int d = 0; d < hd; ++d) s = fmaf(qsm[d], kr[d], s);
    }
    const float wm = warp_max(s);
    if (lane == 0) red[warp] = wm;
    __syncthreads();
    float tmax = red[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) tmax = fmaxf(tmax, red[w]);
    const float m_new = fmaxf(m, tmax);
    const float p = expf(s - m_new);
    const float ws = warp_sum(p);
    if (lane == 0) red[WARPS + warp] = ws;
    ps[tid] = p;
    __syncthreads();  // sums and ps visible; every K read done
    float psum = red[WARPS];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) psum += red[WARPS + w];
    const float alpha = expf(m - m_new);
    l = l * alpha + psum;
    m = m_new;

    for (int e = tid; e < BK * hd; e += THREADS) {
      const int j = e / hd, d = e - j * hd;
      const int vp = k0 + j;
      KV[j * kstride + d] = vp < Sk ? to_f(vb[vp * vs.s + d]) : 0.f;
    }
    __syncthreads();
    const int jmax = min(BK, Sk - k0);
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = tid + THREADS * c;
      if (d < hd) {
        float dot = 0.f;
        for (int j = 0; j < jmax; ++j)
          dot = fmaf(ps[j], KV[j * kstride + d], dot);
        acc[c] = acc[c] * alpha + dot;
      }
    }
  }

  const float inv = fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < DPT; ++c) {
    const int d = tid + THREADS * c;
    if (d < hd) o[b * os.b + h * os.h + d] = from_f<T>(acc[c] / inv);
  }
}

template <typename T, int DPT>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           void* o, int B, int H, int Hkv, int Sk, int hd, Strides qs,
           Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)hd + (size_t)BK * (hd | 1) +
                                       BK + 2 * WARPS);
  auto kern = decode_attention_kernel<T, DPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(H, B), THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, kv_len, (T*)o, H, Hkv, Sk, hd,
      qs, ks, vs, os, (float)std::pow((double)hd, -0.5));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* kv_len,
             void* o, int B, int H, int Hkv, int Sk, int hd, Strides qs,
             Strides ks, Strides vs, Strides os, cudaStream_t s) {
  if (hd <= THREADS)
    return launch<T, 1>(q, k, v, kv_len, o, B, H, Hkv, Sk, hd, qs, ks, vs, os,
                        s);
  return launch<T, 2>(q, k, v, kv_len, o, B, H, Hkv, Sk, hd, qs, ks, vs, os,
                      s);
}

}  // namespace

// q (B, 1, H, hd), k and v (B, Sk, Hkv, hd), out (B, 1, H, hd), all of
// dtype 0 = float32 or 1 = bfloat16, read through the given element
// strides of their first three dims (the last dim has stride 1); kv_len
// (B,) int32. hd is at most 256.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* kv_len, void* o,
    int B, int H, int Hkv, int Sk, int hd, int dtype, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb, long long oss,
    long long osh, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || Sk < 1 || hd < 1 || hd > 256 ||
      kv_len == nullptr)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  const cudaStream_t s = (cudaStream_t)stream;
  const int* kl = (const int*)kv_len;
  if (dtype == 0)
    return dispatch<float>(q, k, v, kl, o, B, H, Hkv, Sk, hd, qs, ks, vs, os,
                           s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, kl, o, B, H, Hkv, Sk, hd, qs, ks,
                                   vs, os, s);
  return (int)cudaErrorInvalidValue;
}
