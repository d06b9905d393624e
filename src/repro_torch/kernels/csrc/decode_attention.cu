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
// float32 arithmetic throughout, inputs float32 or bfloat16 in the model
// layout (B, S, H, hd) read through their strides. Keys past Sk take no
// part. Keys at or past kv_len are skipped when kv_len >= 1 (key 0 is then
// valid and a skipped key would add exp(-1e30 - m) = 0); with kv_len <= 0
// every key scores -1e30 and the result is the mean of V over Sk, as on
// the TPU.
//
// What bounds it on this card: bytes. Each call reads kv_len rows of K
// and V per (b, kv head), 2 kv_len hd elements, and does 4 hd operations
// per row and query head, one operation per byte in bfloat16 without GQA.
// At the serve path's decode (B = 8, 32 heads, hd = 80, kv_len 1025-1088,
// bfloat16) that is 84-89 MB per call, 25-27 us at 3.35 TB/s. The design
// keeps enough bytes in flight to cover the memory's latency:
//
// - Split-K over a thread-block cluster. The grid is (8, Hkv, B) with
//   clusters of 8 blocks along x: block `split` of a cluster owns keys
//   [split * chunk, (split + 1) * chunk) of one (b, kv head), chunk being
//   ceil(Sk / 8) rounded up to 8 keys (set from Sk on the host, never from
//   kv_len, so nothing waits on the device). A chunk that starts at or past
//   the last key to read gives an empty partial (m = -inf, l = 0).
// - GQA: a block serves all g query heads of its kv head (G at a time), so
//   K and V are read once for them all.
// - Loads: a group of LPR lanes takes one key row, each lane one or two
//   16-byte vectors (8 bf16 or 4 float32) of it, straight from global
//   memory into registers; the groups take consecutive keys. Each lane
//   issues the K and V loads of U keys at once, so that V is in flight
//   while the scores are reduced, and no load waits on a previous tile.
//   A row's dot product is reduced across its lanes with shuffles; each
//   group keeps an online softmax (m, l, acc) per head in registers.
// - Combine, in the same launch: the groups' partials are merged in shared
//   memory into the block's, then, after cluster.sync(), each block of the
//   cluster reads the 8 blocks' (m, l, acc) through distributed shared
//   memory for one eighth of the dims and writes them: out = sum_s
//   e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30). Every merge runs
//   in a fixed order, so the result is the same on every run. No global
//   scratch, no second launch.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;
constexpr int NSPLIT = 8;       // blocks per cluster, one chunk of keys each
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Strides {
  long long b, s, h;
};

// 16 bytes of T as floats.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int W = 4;
  static __device__ __forceinline__ void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ float load1(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float store(float x) { return x; }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int W = 8;
  static __device__ __forceinline__ void unpack(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ float load1(const __nv_bfloat16* p) {
    return __bfloat162float(p[0]);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16(x);
  }
};

// Loads the 16-byte vector of row `row` that starts at column c: one
// 128-bit load when `vec` allows it, else element by element (zeros past
// hd; the result is then the same bits as the vector load would give).
template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* row, int c, int hd,
                                          bool vec) {
  constexpr int W = Vec<T>::W;
  if (vec && c + W <= hd)
    return __ldg(reinterpret_cast<const uint4*>(row + c));
  float f[W];
#pragma unroll
  for (int e = 0; e < W; ++e) f[e] = c + e < hd ? Vec<T>::load1(row + c + e)
                                                : 0.f;
  uint32_t w[4];
  if constexpr (W == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __float_as_uint(f[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)  // bf16 values: the high halves are exact
      w[i] = (__float_as_uint(f[2 * i]) >> 16) |
             (__float_as_uint(f[2 * i + 1]) & 0xffff0000u);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// T: element type; LPR lanes per key row, VPL 16-byte vectors per lane
// (so rows up to LPR * VPL * W elements); G query heads per pass. Each
// group has U keys in flight.
template <typename T, int LPR, int VPL, int G>
__global__ void __cluster_dims__(NSPLIT, 1, 1) __launch_bounds__(THREADS)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ kv_len,
                            T* __restrict__ o, int H, int Hkv, int Sk,
                            int hd, Strides qs, Strides ks, Strides vs,
                            Strides os, float scale, int vec, int chunk) {
  constexpr int W = Vec<T>::W;
  constexpr int NG = THREADS / LPR;        // key groups per block
  constexpr int D = VPL * W;               // dims per lane
  constexpr int HDV = LPR * D;             // dims per row, padded
  constexpr int U = 4;                     // keys in flight per group
  extern __shared__ float smem[];
  float* gm = smem;                        // [NG][G] group partials
  float* gl = gm + NG * G;                 // [NG][G]
  float* gacc = gl + NG * G;               // [NG][G][HDV]
  float* bm = gacc + NG * G * HDV;         // [G] block partial
  float* bl = bm + G;                      // [G]
  float* bacc = bl + G;                    // [G][HDV]

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x;            // the block's rank in its cluster
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int g = H / Hkv;
  const int tid = threadIdx.x;
  const int grp = tid / LPR;
  const int lr = tid % LPR;

  const int kvl = kv_len[b];
  const int kend = kvl >= 1 ? min(kvl, Sk) : Sk;
  const int lo = split * chunk;
  const int hi = min(lo + chunk, kend);
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  const bool kvec = vec & 2, vvec = vec & 4;

  for (int h0 = 0; h0 < g; h0 += G) {
    // This lane's dims of the G query rows, scaled before the product.
    float qv[G][D];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int h = hk * g + h0 + u;
      const T* qr = q + b * qs.b + h * qs.h;
#pragma unroll
      for (int p = 0; p < VPL; ++p) {
        float f[W];
        Vec<T>::unpack(h0 + u < g ? load_vec(qr, (lr + LPR * p) * W, hd,
                                             vec & 1)
                                  : make_uint4(0, 0, 0, 0),
                       f);
#pragma unroll
        for (int e = 0; e < W; ++e) qv[u][p * W + e] = f[e] * scale;
      }
    }

    float m[G], l[G], acc[G][D];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      m[u] = -INFINITY;
      l[u] = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[u][d] = 0.f;
    }

    // The same trip count for every thread (the shuffles need whole
    // warps); key j0 + grp + NG i of each step is this group's.
    for (int j0 = lo; j0 < hi; j0 += NG * U) {
      uint4 kr[U][VPL], vr[U][VPL];
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int j = j0 + grp + NG * i;
#pragma unroll
        for (int p = 0; p < VPL; ++p) {
          const int c = (lr + LPR * p) * W;
          const bool in = j < hi && c < hd;
          kr[i][p] = in ? load_vec(kb + j * ks.s, c, hd, kvec)
                        : make_uint4(0, 0, 0, 0);
          vr[i][p] = in ? load_vec(vb + j * vs.s, c, hd, vvec)
                        : make_uint4(0, 0, 0, 0);
        }
      }
      float s[U][G];
#pragma unroll
      for (int i = 0; i < U; ++i) {
#pragma unroll
        for (int u = 0; u < G; ++u) s[i][u] = 0.f;
#pragma unroll
        for (int p = 0; p < VPL; ++p) {
          float f[W];
          Vec<T>::unpack(kr[i][p], f);
#pragma unroll
          for (int u = 0; u < G; ++u)
#pragma unroll
            for (int e = 0; e < W; ++e)
              s[i][u] = fmaf(qv[u][p * W + e], f[e], s[i][u]);
        }
#pragma unroll
        for (int u = 0; u < G; ++u) {
#pragma unroll
          for (int off = 1; off < LPR; off <<= 1)
            s[i][u] += __shfl_xor_sync(FULL, s[i][u], off);
          // Masked (kv_len <= 0: every key) as on the TPU; a key past the
          // chunk takes no part.
          s[i][u] = j0 + grp + NG * i >= hi
                        ? -INFINITY
                        : (kvl >= 1 ? s[i][u] : NEG_INF);
        }
      }
#pragma unroll
      for (int u = 0; u < G; ++u) {
        float mx = s[0][u];
#pragma unroll
        for (int i = 1; i < U; ++i) mx = fmaxf(mx, s[i][u]);
        const float m_new = fmaxf(m[u], mx);
        if (m_new == -INFINITY) continue;  // no key of this group yet
        const float alpha = expf(m[u] - m_new);
        float psum = 0.f;
        float pv[D];
#pragma unroll
        for (int d = 0; d < D; ++d) pv[d] = 0.f;
#pragma unroll
        for (int i = 0; i < U; ++i) {
          const float p = expf(s[i][u] - m_new);
          psum += p;
#pragma unroll
          for (int pp = 0; pp < VPL; ++pp) {
            float f[W];
            Vec<T>::unpack(vr[i][pp], f);
#pragma unroll
            for (int e = 0; e < W; ++e)
              pv[pp * W + e] = fmaf(p, f[e], pv[pp * W + e]);
          }
        }
        l[u] = l[u] * alpha + psum;
        m[u] = m_new;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[u][d] = acc[u][d] * alpha + pv[d];
      }
    }

    // The groups' partials, merged in group order into the block's.
#pragma unroll
    for (int u = 0; u < G; ++u) {
      if (lr == 0) {
        gm[grp * G + u] = m[u];
        gl[grp * G + u] = l[u];
      }
#pragma unroll
      for (int p = 0; p < VPL; ++p)
#pragma unroll
        for (int e = 0; e < W; ++e)
          gacc[(grp * G + u) * HDV + (lr + LPR * p) * W + e] =
              acc[u][p * W + e];
    }
    __syncthreads();
    for (int idx = tid; idx < G * hd; idx += THREADS) {
      const int u = idx / hd, d = idx - u * hd;
      float M = -INFINITY;
      for (int r = 0; r < NG; ++r) M = fmaxf(M, gm[r * G + u]);
      float L = 0.f, A = 0.f;
      if (M != -INFINITY) {
        for (int r = 0; r < NG; ++r) {
          const float mr = gm[r * G + u];
          const float w = mr == -INFINITY ? 0.f : expf(mr - M);
          L = L + w * gl[r * G + u];
          A = fmaf(w, gacc[(r * G + u) * HDV + d], A);
        }
      }
      if (d == 0) {
        bm[u] = M;
        bl[u] = L;
      }
      bacc[u * HDV + d] = A;
    }

    // The cluster's 8 partials, merged in split order; block `split`
    // writes dims [split * dpr, (split + 1) * dpr) of the output.
    cluster.sync();
    {
      const int nh = min(G, g - h0);
      const int dpr = (hd + NSPLIT - 1) / NSPLIT;
      const int nd = max(0, min(dpr, hd - split * dpr));
      for (int idx = tid; idx < nh * nd; idx += THREADS) {
        const int u = idx / nd, d = split * dpr + idx - u * nd;
        float ms[NSPLIT];
        float M = -INFINITY;
#pragma unroll
        for (int r = 0; r < NSPLIT; ++r) {
          ms[r] = *cluster.map_shared_rank(bm + u, r);
          M = fmaxf(M, ms[r]);
        }
        float L = 0.f, A = 0.f;
#pragma unroll
        for (int r = 0; r < NSPLIT; ++r) {
          const float w = ms[r] == -INFINITY ? 0.f : expf(ms[r] - M);
          L = L + w * *cluster.map_shared_rank(bl + u, r);
          A = fmaf(w, *cluster.map_shared_rank(bacc + u * HDV + d, r), A);
        }
        const int h = hk * g + h0 + u;
        o[b * os.b + h * os.h + d] = Vec<T>::store(A / fmaxf(L, 1e-30f));
      }
    }
    // No block reuses or frees its shared memory while another reads it.
    cluster.sync();
  }
}

template <typename T, int LPR, int VPL, int G>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           void* o, int B, int H, int Hkv, int Sk, int hd, Strides qs,
           Strides ks, Strides vs, Strides os, int vec, cudaStream_t stream) {
  constexpr int NG = THREADS / LPR;
  constexpr int HDV = LPR * VPL * Vec<T>::W;
  const size_t smem =
      sizeof(float) * ((size_t)(NG + 1) * G * (HDV + 2));
  auto kern = decode_attention_kernel<T, LPR, VPL, G>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int per = (Sk + NSPLIT - 1) / NSPLIT;
  const int chunk = (per + 7) / 8 * 8;
  kern<<<dim3(NSPLIT, Hkv, B), THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, kv_len, (T*)o, H, Hkv, Sk, hd,
      qs, ks, vs, os, (float)std::pow((double)hd, -0.5), vec, chunk);
  return (int)cudaGetLastError();
}

template <typename T, int LPR, int VPL>
int by_group(const void* q, const void* k, const void* v, const int* kv_len,
             void* o, int B, int H, int Hkv, int Sk, int hd, Strides qs,
             Strides ks, Strides vs, Strides os, int vec, cudaStream_t s) {
  const int g = H / Hkv;
  if (g == 1)
    return launch<T, LPR, VPL, 1>(q, k, v, kv_len, o, B, H, Hkv, Sk, hd, qs,
                                  ks, vs, os, vec, s);
  if (g == 2)
    return launch<T, LPR, VPL, 2>(q, k, v, kv_len, o, B, H, Hkv, Sk, hd, qs,
                                  ks, vs, os, vec, s);
  if (g <= 4)
    return launch<T, LPR, VPL, 4>(q, k, v, kv_len, o, B, H, Hkv, Sk, hd, qs,
                                  ks, vs, os, vec, s);
  return launch<T, LPR, VPL, 8>(q, k, v, kv_len, o, B, H, Hkv, Sk, hd, qs, ks,
                                vs, os, vec, s);
}

bool aligned16(const void* p, Strides st, int elem) {
  const long long w = 16 / elem;  // elements per 16 bytes
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && st.b % w == 0 &&
         st.s % w == 0 && st.h % w == 0;
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* kv_len,
             void* o, int B, int H, int Hkv, int Sk, int hd, Strides qs,
             Strides ks, Strides vs, Strides os, cudaStream_t s) {
  constexpr int W = Vec<T>::W;
  const int vec = (aligned16(q, qs, sizeof(T)) ? 1 : 0) |
                  (aligned16(k, ks, sizeof(T)) ? 2 : 0) |
                  (aligned16(v, vs, sizeof(T)) ? 4 : 0);
  const int vpr = (hd + W - 1) / W;  // 16-byte vectors per row
  if (vpr <= 8)
    return by_group<T, 8, 1>(q, k, v, kv_len, o, B, H, Hkv, Sk, hd, qs, ks,
                             vs, os, vec, s);
  if (vpr <= 16)
    return by_group<T, 16, 1>(q, k, v, kv_len, o, B, H, Hkv, Sk, hd, qs, ks,
                              vs, os, vec, s);
  if (vpr <= 32)
    return by_group<T, 32, 1>(q, k, v, kv_len, o, B, H, Hkv, Sk, hd, qs, ks,
                              vs, os, vec, s);
  if constexpr (W == 4)  // float32 rows of 132-256 elements
    return by_group<T, 32, 2>(q, k, v, kv_len, o, B, H, Hkv, Sk, hd, qs, ks,
                              vs, os, vec, s);
  return (int)cudaErrorInvalidValue;
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
      kv_len == nullptr || B > 65535 || Hkv > 65535)
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
