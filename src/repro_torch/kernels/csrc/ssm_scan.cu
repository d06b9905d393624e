// Chunked Mamba2 (SSD) scan for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan/kernel.py
// ssd_scan_bhlp (body _ssd_kernel). Per (batch b, head h), chunk by chunk
// of Q steps, with cl the inclusive cumsum of loga = dt * A in the chunk:
//
//   W_ij = (C_i . B_j) exp(cl_i - cl_j) dt_j        for j <= i only
//   y_i  = sum_j W_ij x_j + exp(cl_i) (C_i . S)
//   S   <- exp(cl_last) S + sum_j B_j (x_j exp(cl_last - cl_j) dt_j)^T
//
// carrying the (N, P) state S over the chunks and writing the last one
// out, all in float32 (x float32 or bfloat16, read through its strides in
// the model layout (B, L, H, P); y in x's dtype), but for the cumsum,
// taken in float64 and rounded once: cl reaches -100 and more within a
// chunk, and its rounding, not the products', sets the difference between
// two summation orders. The decay is formed only for j <= i: above the
// diagonal exp(cl_i - cl_j) can overflow to inf, and the TPU's
// where(causal, exp, 0) must not become inf * 0 = NaN here.
//
// What bounds it on this card: operations. Per (b, h) and chunk about
// Q^2 N / 2 + Q^2 P / 2 + 2 Q N P multiply-adds against Q (P + 2 N + 2)
// float32 reads, some 40 operations per byte at Q = 128, N = P = 64; at
// the serve path's prefill (B = 8, 80 heads, L = 1024) 21.6 GFLOP per
// call, all of it matrix products.
//
// Two routes, chosen by shape in the wrapper, one launch each:
//
// * ssd_scan_tc_launch (Q a multiple of 16 up to 128, N a multiple of 16
//   up to 64, P a multiple of 8 up to 64; the serve shape). The four
//   products run on the tensor cores, mma.sync m16n8k8 TF32 with float32
//   accumulation, each float32 operand split as a = hi + lo (hi =
//   tf32(a), lo = tf32(a - hi), both rounded to nearest, ties away) and
//   each product taken as lo*hi + hi*lo + hi*hi (3xTF32): float32-level
//   accuracy. Operands exact in TF32 take fewer passes: a bfloat16 x (W x
//   and the state update, two), bfloat16 or float16 B and C, as the model
//   passes them (C.B^T one, C.S two). Each product weighted by its passes
//   at 495 TFLOP/s (C.B^T of bf16 operands at the bf16 rate, 989), the
//   serve call's products take at least 0.071 ms (chip_smoke.py's
//   ssd_products).
//   One block of 4 warps per (b, h), two blocks per SM. Warp w owns the
//   16-row tiles w and Q/16 - 1 - w of the chunk (equal causal work). For
//   each, C's fragments come from global memory (L2: C is shared by every
//   head) straight into registers and serve as the A operand of both
//   C.B^T and C.S; the C.B^T accumulator (two chains of k-steps, so that
//   two tensor-core ops are in flight per column block), scaled and masked
//   in registers, is the A operand of W x, its k index permuted (j = 2t
//   and 2t + 1) so that no shuffle is needed. The state update gives warp
//   w the 16 state rows 16w.. . Every loop runs over 64 columns (zeros
//   past N and P), so none branches.
//   Shared memory (100 KB at the serve shape, bf16 x): x in its storage
//   dtype in a 2-stage cp.async ring (the next chunk's x arrives while this
//   one computes), the B tile, and the state as (S, lo) pairs, so that C.S
//   reads its split; rows of 64 are XOR-swizzled against bank conflicts.
//   The next chunk's dt and loga go into the registers of the cumsum warp.
//   B is loaded once its last reader is done (a second B stage would push
//   the block past half the SM's shared memory).
// * ssd_scan_launch (any other shape): one block of 512 threads per (b, h)
//   with scalar float32 fmaf products on the CUDA cores, the chunk's B, C,
//   x tiles, the (Q, Q) weights and the state in shared memory (179 KB at
//   Q = 128, N = P = 64: one block per SM).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 512;
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

// ---------------------------------------------------------------------------
// CUDA-core route
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ loga,
                    const float* __restrict__ Bm,
                    const float* __restrict__ Cm, T* __restrict__ y,
                    float* __restrict__ S_out, int L, int H, int P, int N,
                    int Q, long long xsb, long long xsl, long long xsh) {
  extern __shared__ float smem[];
  const int nb = N | 1;             // odd row stride of the B tile
  float* Bs = smem;                 // [Q][nb]
  float* Cs = Bs + Q * nb;          // [Q][N]
  float* Xs = Cs + Q * N;           // [Q][P]
  float* W = Xs + Q * P;            // [Q][Q], lower triangle
  float* Ss = W + Q * Q;            // [N][P]
  float* cl = Ss + N * P;           // [Q]
  float* dts = cl + Q;              // [Q]
  float* ecl = dts + Q;             // [Q] exp(cl_i)
  float* cf = ecl + Q;              // [Q] exp(cl_last - cl_j) dt_j

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t row0 = (size_t)b * L;  // row of (b, l = 0) in dt, B, C

  for (int e = tid; e < N * P; e += THREADS) Ss[e] = 0.f;

  for (int l0 = 0; l0 < L; l0 += Q) {
    __syncthreads();  // the previous chunk's reads of every tile are done
    for (int e = tid; e < Q * N; e += THREADS) {
      const int j = e / N, n = e - j * N;
      const size_t g = (row0 + l0 + j) * N + n;
      Bs[j * nb + n] = Bm[g];
      Cs[e] = Cm[g];
    }
    for (int e = tid; e < Q * P; e += THREADS) {
      const int j = e / P, p = e - j * P;
      Xs[e] = to_f(x[b * xsb + (long long)(l0 + j) * xsl + h * xsh + p]);
    }
    if (warp == 0) {
      // Inclusive cumsum of loga over the chunk, 32 steps at a time, in
      // float64 and rounded once, so that cl does not depend on the order
      // of the sum (the plain version takes it the same way).
      double carry = 0.0;
      for (int base = 0; base < Q; base += 32) {
        const int j = base + lane;
        const size_t g = (row0 + l0 + j) * H + h;
        double v = j < Q ? (double)loga[g] : 0.0;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const double t = __shfl_up_sync(FULL, v, off);
          if (lane >= off) v += t;
        }
        v += carry;
        if (j < Q) {
          cl[j] = (float)v;
          dts[j] = dt[g];
        }
        carry = __shfl_sync(FULL, v, 31);
      }
    }
    __syncthreads();

    const float cl_last = cl[Q - 1];
    for (int j = tid; j < Q; j += THREADS) {
      ecl[j] = expf(cl[j]);
      cf[j] = expf(cl_last - cl[j]) * dts[j];
    }
    for (int e = tid; e < Q * Q; e += THREADS) {
      const int i = e / Q, j = e - i * Q;
      if (j > i) continue;
      const float* ci = Cs + i * N;
      const float* bj = Bs + j * nb;
      float cb = 0.f;
      for (int n = 0; n < N; ++n) cb = fmaf(ci[n], bj[n], cb);
      W[e] = cb * expf(cl[i] - cl[j]) * dts[j];
    }
    __syncthreads();

    for (int e = tid; e < Q * P; e += THREADS) {
      const int i = e / P, p = e - i * P;
      const float* wi = W + i * Q;
      float acc = 0.f;
      for (int j = 0; j <= i; ++j) acc = fmaf(wi[j], Xs[j * P + p], acc);
      const float* ci = Cs + i * N;
      float inter = 0.f;
      for (int n = 0; n < N; ++n) inter = fmaf(ci[n], Ss[n * P + p], inter);
      acc += ecl[i] * inter;
      // y is contiguous (B, L, H, P).
      y[((row0 + l0 + i) * H + h) * P + p] = from_f<T>(acc);
    }
    __syncthreads();  // every read of the old state is done

    const float decay = expf(cl_last);
    for (int e = tid; e < N * P; e += THREADS) {
      const int n = e / P, p = e - n * P;
      float acc = 0.f;
      for (int j = 0; j < Q; ++j)
        acc = fmaf(Bs[j * nb + n], Xs[j * P + p] * cf[j], acc);
      Ss[e] = decay * Ss[e] + acc;
    }
  }
  __syncthreads();
  float* so = S_out + ((size_t)b * H + h) * N * P;
  for (int e = tid; e < N * P; e += THREADS) so[e] = Ss[e];
}

template <typename T>
int launch(const void* x, const float* dt, const float* loga, const float* Bm,
           const float* Cm, void* y, float* S, int B, int L, int H, int P,
           int N, int Q, int smem, long long xsb, long long xsl,
           long long xsh, cudaStream_t stream) {
  auto kern = ssd_scan_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(H, B), THREADS, smem, stream>>>(
      (const T*)x, dt, loga, Bm, Cm, (T*)y, S, L, H, P, N, Q, xsb, xsl, xsh);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tensor-core route: mma.sync m16n8k8 TF32, 3xTF32
// ---------------------------------------------------------------------------
constexpr int TC_THREADS = 128;  // 4 warps
constexpr int TC_ROW = 64;       // elements per shared-memory tile row

// cvt.rna.tf32.f32 for finite v (and inf): add half a TF32 ulp to the
// magnitude bits, then clear the 13 low ones. Two integer instructions,
// where the compiler's cvt adds a test for inf and NaN.
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo, both TF32: hi = tf32(v), lo = tf32(v - hi).
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

// d += a b on the tensor cores, a (16 x 8) row-major, b (8 x 8) col-major.
// Fragment of lane (g = lane / 4, t = lane % 4): a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); b0 (t, g), b1 (t + 4, g); d0 (g, 2t),
// d1 (g, 2t + 1), d2 (g + 8, 2t), d3 (g + 8, 2t + 1).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b, a given as (hi, lo), b as its TF32 (hi, lo) parts: lo*hi, then
// hi*lo, then hi*hi. When a is exact in TF32 (EXACT_A: a bfloat16 B or C)
// lo*hi adds nothing and is left out.
template <bool EXACT_A>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  if (!EXACT_A) mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

// d += a x with a float32 (hi, lo) and x the chunk's x in its storage
// dtype: a bfloat16 is exact in TF32 (lo*x, then hi*x), a float32 is split.
__device__ __forceinline__ void mma_x(float (&d)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4],
                                      __nv_bfloat16 b0, __nv_bfloat16 b1) {
  const uint32_t u0 = __float_as_uint(__bfloat162float(b0));
  const uint32_t u1 = __float_as_uint(__bfloat162float(b1));
  mma(d, al, u0, u1);
  mma(d, ah, u0, u1);
}
__device__ __forceinline__ void mma_x(float (&d)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], float b0,
                                      float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma3<false>(d, ah, al, bh0, bh1, bl0, bl1);
}

// Shared-memory tiles are rows of 64 elements whose columns are XORed
// with a function of the row, so that each fragment read below touches 32
// distinct banks (or shares a word): B (float32) flips column bits 2-4 by
// (r & 3, r >> 2 & 1); x flips bits 3-5 by r & 7 (bfloat16) or bits 3-4 by
// (r ^ r >> 2) & 3 (float32); the state, kept as (S, lo) float2 pairs,
// flips pair bits 2-3 by r & 3 (16 distinct bank pairs per half-warp).
// 16-byte groups stay whole, so cp.async fills them as they are.
__device__ __forceinline__ int sw_b(int r, int c) {
  return r * TC_ROW + (c ^ (((r & 3) << 3) | (((r >> 2) & 1) << 2)));
}
__device__ __forceinline__ int sw_x(const float*, int r, int c) {
  return r * TC_ROW + (c ^ (((r ^ (r >> 2)) & 3) << 3));
}
__device__ __forceinline__ int sw_x(const __nv_bfloat16*, int r, int c) {
  return r * TC_ROW + (c ^ ((r & 7) << 3));
}
__device__ __forceinline__ int sw_s(int r, int c) {
  return r * TC_ROW + (c ^ ((r & 3) << 2));
}
// The state value with its TF32 lo part, as C.S reads it.
__device__ __forceinline__ float2 with_lo(float v) {
  return make_float2(v, __uint_as_float(tf32(v - __uint_as_float(tf32(v)))));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;");
}
__device__ __forceinline__ void cp_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// EXACT_BC: B and C hold bfloat16 (or float16) values, exact in TF32, so
// their lo parts are zero and the products that would multiply them are
// left out (C.B^T one pass, C.S two): the same sums, bit for bit.
template <typename T, bool EXACT_BC>
__global__ void __launch_bounds__(TC_THREADS, 2)
    ssd_scan_tc_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ loga,
                       const float* __restrict__ Bm,
                       const float* __restrict__ Cm, T* __restrict__ y,
                       float* __restrict__ S_out, int L, int H, int P, int N,
                       int Q, long long xsb, long long xsl, long long xsh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);                   // [2][Q][64]
  float* Bs = reinterpret_cast<float*>(xs + 2 * Q * TC_ROW);  // [Q][64]
  float2* Ss = reinterpret_cast<float2*>(Bs + Q * TC_ROW);  // [64][64]
  float* cls = reinterpret_cast<float*>(Ss + TC_ROW * TC_ROW);  // [Q] cl_j
  float* dts = cls + Q;                               // [Q] dt_j
  float* ecl = dts + Q;                               // [Q] exp(cl_i)
  float* cfs = ecl + Q;                               // [Q] exp(cl_last - cl_j) dt_j

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t row0 = (size_t)b * L;  // row of (b, l = 0) in dt, B, C
  const int RT = Q / 16;
  const int nchunks = L / Q;
  // This warp's row tiles: w and RT - 1 - w (one, or none, when RT is
  // small).
  const int n_tiles = warp < (RT + 1) / 2 ? (RT - 1 - warp != warp ? 2 : 1)
                                          : 0;

  // Every product runs over all 64 columns of a tile: those past N (B, C,
  // S) hold zeros, and those past P (x, y, S) are computed and dropped,
  // so that the loops have fixed bounds and no branches.
  for (int e = tid; e < TC_ROW * TC_ROW; e += TC_THREADS)
    Ss[e] = make_float2(0.f, 0.f);
  for (int e = tid; e < Q * TC_ROW; e += TC_THREADS) {
    Bs[e] = 0.f;
    xs[e] = xs[Q * TC_ROW + e] = from_f<T>(0.f);
  }
  __syncthreads();

  auto load_x = [&](int c, int stage) {
    constexpr int CH = 16 / sizeof(T);  // elements per 16-byte group
    const int per_row = P / CH;
    T* dst = xs + stage * Q * TC_ROW;
    for (int e = tid; e < Q * per_row; e += TC_THREADS) {
      const int j = e / per_row, k = (e - j * per_row) * CH;
      cp_async16(dst + sw_x(dst, j, k),
                 x + b * xsb + (long long)(c * Q + j) * xsl + h * xsh + k);
    }
  };
  auto load_b = [&](int c) {
    const int per_row = N / 4;
    for (int e = tid; e < Q * per_row; e += TC_THREADS) {
      const int j = e / per_row, k = (e - j * per_row) * 4;
      cp_async16(Bs + sw_b(j, k), Bm + (row0 + c * Q + j) * N + k);
    }
  };
  // The cumsum warp's next dt and loga, one value per lane and 32 steps.
  float la[4], dd[4];
  auto fetch_dt = [&](int c) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 32 * k + lane;
      if (j < Q) {
        const size_t gi = (row0 + (size_t)c * Q + j) * H + h;
        la[k] = __ldg(loga + gi);
        dd[k] = __ldg(dt + gi);
      }
    }
  };

  if (warp == 0) fetch_dt(0);
  load_x(0, 0);
  load_b(0);
  cp_commit();

  for (int c = 0; c < nchunks; ++c) {
    const int stage = c & 1;
    const size_t l0 = (size_t)c * Q;
    if (warp == 0) {
      // Inclusive cumsum of loga in float64, rounded once (as the
      // CUDA-core route and the plain version take it).
      double carry = 0.0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (32 * k >= Q) break;
        const int j = 32 * k + lane;
        double v = j < Q ? (double)la[k] : 0.0;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const double u = __shfl_up_sync(FULL, v, off);
          if (lane >= off) v += u;
        }
        v += carry;
        if (j < Q) {
          cls[j] = (float)v;
          dts[j] = dd[k];
        }
        carry = __shfl_sync(FULL, v, 31);
      }
      __syncwarp();
      const float cl_last = cls[Q - 1];
      for (int j = lane; j < Q; j += 32) {
        ecl[j] = expf(cls[j]);
        cfs[j] = expf(cl_last - cls[j]) * dts[j];
      }
      if (c + 1 < nchunks) fetch_dt(c + 1);
    }
    if (c + 1 < nchunks) load_x(c + 1, stage ^ 1);
    cp_commit();
    cp_wait_all_but_newest();  // chunk c's x and B have landed
    __syncthreads();

    const T* xc = xs + stage * Q * TC_ROW;
    // ---- y, row tile by row tile ------------------------------------------
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      if (side >= n_tiles) break;
      const int r = side ? RT - 1 - warp : warp;
      const int ia = 16 * r + g, ib = ia + 8;
      // C's fragments: rows ia, ib; columns 8 ks + t and 8 ks + t + 4
      // (zero past N).
      uint32_t ch[8][4], cl_[8][4];
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const bool in = 8 * ks < N;
        const float* ca = Cm + (row0 + l0 + ia) * N + (in ? 8 * ks + t : 0);
        const float* cb = ca + 8 * (size_t)N;
        const float v[4] = {in ? __ldg(ca) : 0.f, in ? __ldg(cb) : 0.f,
                            in ? __ldg(ca + 4) : 0.f,
                            in ? __ldg(cb + 4) : 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (EXACT_BC) {
            ch[ks][e] = __float_as_uint(v[e]);
            cl_[ks][e] = 0u;
          } else {
            split(v[e], ch[ks][e], cl_[ks][e]);
          }
        }
      }
      // exp(cl_i) (C_i . S)
      float acc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float2 s0 = Ss[sw_s(8 * ks + t, 8 * nt + g)];
          const float2 s1 = Ss[sw_s(8 * ks + t + 4, 8 * nt + g)];
          mma3<EXACT_BC>(acc[nt], ch[ks], cl_[ks], tf32(s0.x), tf32(s1.x),
                         __float_as_uint(s0.y), __float_as_uint(s1.y));
        }
      }
      const float ea = ecl[ia], eb = ecl[ib];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[nt][0] *= ea;
        acc[nt][1] *= ea;
        acc[nt][2] *= eb;
        acc[nt][3] *= eb;
      }
      const float cla = cls[ia], clb = cls[ib];
      // + W x, 16 columns j at a time up to the diagonal
      for (int jp = 0; jp <= r; ++jp) {
        // C.B^T for columns 16 jp + 8 q + (0..7), its k-steps in two
        // chains (even and odd) that are added at the end.
        float cbp[2][2][4];
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            cbp[q][e][0] = cbp[q][e][1] = cbp[q][e][2] = cbp[q][e][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int j = 16 * jp + 8 * q + g;
            const float b0 = Bs[sw_b(j, 8 * ks + t)];
            const float b1 = Bs[sw_b(j, 8 * ks + t + 4)];
            if (EXACT_BC) {
              mma(cbp[q][ks & 1], ch[ks], __float_as_uint(b0),
                  __float_as_uint(b1));
            } else {
              uint32_t bh0, bl0, bh1, bl1;
              split(b0, bh0, bl0);
              split(b1, bh1, bl1);
              mma3<false>(cbp[q][ks & 1], ch[ks], cl_[ks], bh0, bh1, bl0,
                          bl1);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float cbt[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) cbt[e] = cbp[q][0][e] + cbp[q][1][e];
          // cbt holds (C.B^T) at (ia | ib, ja | jb); as the A operand of
          // W x its k index t stands for column ja and t + 4 for jb.
          const int ja = 16 * jp + 8 * q + 2 * t, jb = ja + 1;
          const float ca = cls[ja], cb = cls[jb];
          const float da = dts[ja], db = dts[jb];
          const float w0 = ja <= ia ? cbt[0] * expf(cla - ca) * da : 0.f;
          const float w1 = jb <= ia ? cbt[1] * expf(cla - cb) * db : 0.f;
          const float w2 = ja <= ib ? cbt[2] * expf(clb - ca) * da : 0.f;
          const float w3 = jb <= ib ? cbt[3] * expf(clb - cb) * db : 0.f;
          uint32_t wh[4], wl[4];
          split(w0, wh[0], wl[0]);
          split(w2, wh[1], wl[1]);
          split(w1, wh[2], wl[2]);
          split(w3, wh[3], wl[3]);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int p = 8 * nt + g;
            mma_x(acc[nt], wh, wl, xc[sw_x(xc, ja, p)], xc[sw_x(xc, jb, p)]);
          }
        }
      }
      // y is contiguous (B, L, H, P).
      T* ya = y + ((row0 + l0 + ia) * H + h) * P + 2 * t;
      T* yb = y + ((row0 + l0 + ib) * H + h) * P + 2 * t;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (8 * nt < P) {
          store2(ya + 8 * nt, acc[nt][0], acc[nt][1]);
          store2(yb + 8 * nt, acc[nt][2], acc[nt][3]);
        }
      }
    }
    __syncthreads();  // every read of the old state is done

    // ---- S <- exp(cl_last) S + (B cf)^T x: warp w owns rows 16w.. -------
    if (warp < N / 16) {
      const int na = 16 * warp + g, nb = na + 8;
      const float decay = expf(cls[Q - 1]);
      float acc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int p = 8 * nt + 2 * t;
        acc[nt][0] = decay * Ss[sw_s(na, p)].x;
        acc[nt][1] = decay * Ss[sw_s(na, p + 1)].x;
        acc[nt][2] = decay * Ss[sw_s(nb, p)].x;
        acc[nt][3] = decay * Ss[sw_s(nb, p + 1)].x;
      }
      for (int ks = 0; ks < Q / 8; ++ks) {
        const int ja = 8 * ks + t, jb = ja + 4;
        const float fa = cfs[ja], fb = cfs[jb];
        uint32_t ah[4], al[4];
        split(Bs[sw_b(ja, na)] * fa, ah[0], al[0]);
        split(Bs[sw_b(ja, nb)] * fa, ah[1], al[1]);
        split(Bs[sw_b(jb, na)] * fb, ah[2], al[2]);
        split(Bs[sw_b(jb, nb)] * fb, ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int p = 8 * nt + g;
          mma_x(acc[nt], ah, al, xc[sw_x(xc, ja, p)], xc[sw_x(xc, jb, p)]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int p = 8 * nt + 2 * t;
        Ss[sw_s(na, p)] = with_lo(acc[nt][0]);
        Ss[sw_s(na, p + 1)] = with_lo(acc[nt][1]);
        Ss[sw_s(nb, p)] = with_lo(acc[nt][2]);
        Ss[sw_s(nb, p + 1)] = with_lo(acc[nt][3]);
      }
    }
    __syncthreads();  // every read of B, of x's stage and of cl is done
    if (c + 1 < nchunks) load_b(c + 1);
    cp_commit();
  }
  float* so = S_out + ((size_t)b * H + h) * N * P;
  for (int e = tid; e < N * P; e += TC_THREADS) {
    const int n = e / P, p = e - n * P;
    so[e] = Ss[sw_s(n, p)].x;
  }
}

template <typename T, bool EXACT_BC>
int launch_tc(const void* x, const float* dt, const float* loga,
              const float* Bm, const float* Cm, void* y, float* S, int B,
              int L, int H, int P, int N, int Q, int smem, long long xsb,
              long long xsl, long long xsh, cudaStream_t stream) {
  auto kern = ssd_scan_tc_kernel<T, EXACT_BC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(H, B), TC_THREADS, smem, stream>>>(
      (const T*)x, dt, loga, Bm, Cm, (T*)y, S, L, H, P, N, Q, xsb, xsl, xsh);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tc(int exact_bc, const void* x, const float* dt,
              const float* loga, const float* Bm, const float* Cm, void* y,
              float* S, int B, int L, int H, int P, int N, int Q, int smem,
              long long xsb, long long xsl, long long xsh,
              cudaStream_t stream) {
  return exact_bc ? launch_tc<T, true>(x, dt, loga, Bm, Cm, y, S, B, L, H, P,
                                       N, Q, smem, xsb, xsl, xsh, stream)
                  : launch_tc<T, false>(x, dt, loga, Bm, Cm, y, S, B, L, H,
                                        P, N, Q, smem, xsb, xsl, xsh, stream);
}

}  // namespace

// x (B, L, H, P) of dtype 0 = float32 or 1 = bfloat16, read through its
// element strides (xsb, xsl, xsh; the last dim has stride 1); dt and
// loga (B, L, H), Bm and Cm (B, L, N) float32, contiguous; y (B, L, H, P)
// in x's dtype and S (B, H, N, P) float32, contiguous. L is a multiple of
// Q; smem is the dynamic shared memory in bytes, as the wrapper computes
// it: 4 (Q (N | 1) + Q N + Q P + Q Q + N P + 4 Q).
extern "C" int ssd_scan_launch(const void* x, const void* dt,
                               const void* loga, const void* Bm,
                               const void* Cm, void* y, void* S, int B, int L,
                               int H, int P, int N, int Q, int smem,
                               int dtype, long long xsb, long long xsl,
                               long long xsh, void* stream) {
  if (B < 1 || L < 1 || H < 1 || P < 1 || N < 1 || Q < 1 || L % Q ||
      smem != 4 * (Q * (N | 1) + Q * N + Q * P + Q * Q + N * P + 4 * Q))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* f_dt = (const float*)dt;
  const float* f_la = (const float*)loga;
  const float* f_b = (const float*)Bm;
  const float* f_c = (const float*)Cm;
  if (dtype == 0)
    return launch<float>(x, f_dt, f_la, f_b, f_c, y, (float*)S, B, L, H, P, N,
                         Q, smem, xsb, xsl, xsh, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, f_dt, f_la, f_b, f_c, y, (float*)S, B, L,
                                 H, P, N, Q, smem, xsb, xsl, xsh, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core route, the same arguments and exact_bc: 1 when Bm and
// Cm hold bfloat16 or float16 values (exact in TF32). Q a multiple of 16
// in [16, 128], N a multiple of 16 in [16, 64], P a multiple of 8 in [8,
// 64]; x's base and its strides times the element size multiples of 16
// bytes; smem = 2 Q 64 sizeof(x) + 4 Q 64 + 8 64 64 + 16 Q.
extern "C" int ssd_scan_tc_launch(const void* x, const void* dt,
                                  const void* loga, const void* Bm,
                                  const void* Cm, void* y, void* S, int B,
                                  int L, int H, int P, int N, int Q, int smem,
                                  int dtype, long long xsb, long long xsl,
                                  long long xsh, int exact_bc, void* stream) {
  const int esize = dtype == 0 ? 4 : 2;
  if (B < 1 || L < 1 || H < 1 || L % Q || Q % 16 || Q < 16 || Q > 128 ||
      N % 16 || N < 16 || N > 64 || P % 8 || P < 8 || P > 64 ||
      (dtype != 0 && dtype != 1) || (uintptr_t)x % 16 ||
      (xsb * esize) % 16 || (xsl * esize) % 16 || (xsh * esize) % 16 ||
      smem != 2 * Q * TC_ROW * esize + 4 * Q * TC_ROW +
                  8 * TC_ROW * TC_ROW + 16 * Q)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* f_dt = (const float*)dt;
  const float* f_la = (const float*)loga;
  const float* f_b = (const float*)Bm;
  const float* f_c = (const float*)Cm;
  if (dtype == 0)
    return launch_tc<float>(exact_bc, x, f_dt, f_la, f_b, f_c, y, (float*)S,
                            B, L, H, P, N, Q, smem, xsb, xsl, xsh, s);
  return launch_tc<__nv_bfloat16>(exact_bc, x, f_dt, f_la, f_b, f_c, y,
                                  (float*)S, B, L, H, P, N, Q, smem, xsb, xsl,
                                  xsh, s);
}
