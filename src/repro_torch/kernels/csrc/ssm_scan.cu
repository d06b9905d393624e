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
// What bounds it on this card. Operations: per (b, h) and chunk about
// Q^2 N / 2 + Q^2 P / 2 + 2 Q N P multiply-adds against Q (P + 2 N + 2)
// float32 reads, some 40 operations per byte at Q = 128, N = P = 64; at
// the serve path's prefill (B = 8, 80 heads, L = 1024) about 21 GFLOP per
// call. All of it is matrix products that tensor cores could take.
//
// What the design does: one block of 512 threads per (b, h), 640 blocks at
// that shape, walking the chunks in order with the state in shared memory
// (the TPU's sequential grid axis becomes the loop). A chunk's B, C and x
// tiles, the (Q, Q) weights and the state live in shared memory, 179 KB at
// Q = 128, N = P = 64, hence the dynamic shared-memory attribute and one
// block per SM. B's rows sit at an odd stride so that the 32 lanes of a
// warp, each on its own j, read 32 banks. The cumsum is a warp scan. The
// products run on the float32 CUDA cores with explicit fmaf (the library
// is built with -fmad=false); wgmma tiles, and sharing C.B^T over the
// heads of one batch row, are later work.
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
