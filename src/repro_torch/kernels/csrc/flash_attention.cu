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
// their strides. No padding in memory: keys past Sk take no part at all
// and query rows past Sq are not stored. Key blocks that every row of a
// tile masks (past kv_len, or above the causal diagonal) are skipped when
// kv_len >= 1: every row then has key 0 valid, so a skipped key would have
// added exp(-1e30 - m) = 0. The entry point picks the kernel by dtype.
//
// What bounds it on this card. At the serve path's prefill (B = 8, H = 32,
// Sq = Sk = 1024, hd = 80, causal, bf16) it does about 4 B H Sq Sk hd / 2
// = 43 GFLOP against 168 MB of q, k, v and out: 256 operations per byte,
// just under the card's ridge point (989 TFLOP/s over 3.35 TB/s, 295), so
// the bound is the bytes, 0.050 ms, against 0.043 ms for the operations.
//
// bfloat16 (flash_bf16_kernel): both products on the tensor cores with
// wgmma. A block holds one consumer warpgroup of 64 query rows and one
// producer warp. The producer loads Q once and K and V tiles of 64 keys, as
// bf16, with TMA (tensor maps encoded on the host through
// cudaGetDriverEntryPoint, no -lcuda) into a ring of shared-memory stages
// completed on mbarriers, so that loads overlap the products. Only strides
// that TMA cannot describe (zero, negative, or not a multiple of 16 bytes)
// take cp.async copies of 16 bytes, or element by element, instead; where
// TMA can describe them and the driver refuses a map, the launch fails. S = Q K^T takes the unscaled bf16 q and k from shared memory
// (both K-major) into float32 registers, and the float32 score is then
// multiplied by the scale: that differs from the reference's (q * scale) .
// k by float32 rounding only, where rounding q * scale to bf16 first would
// add a bf16 rounding to every score. The online softmax stays in
// registers (row max and sum across the four threads that share a row). P
// is rounded to bf16 and fed to the second wgmma from registers (the
// accumulator's fragment layout is the register-A layout), with V from
// shared memory under the transpose bit; l sums the float32 p, as the
// reference does. Rounding P adds at most about 2^-9 max|v| to an output,
// inside the bf16 tolerance. Inside a group of heads, the grid takes the
// heaviest causal query blocks first. Measured at the serve shape (PERF.md
// §6), the kernel is bound by the latency of each warpgroup's chain (Q K^T,
// softmax, P V) per tile, not by its loads.
//
// float32 (flash_attention_kernel): the products stay on the float32 CUDA
// cores. TF32 tensor cores keep 10 bits of mantissa and would break the
// float32 tolerance (atol 1e-5) that the tests and the full-width float32
// serve parity hold. One block of 8 warps takes 64 query rows of one
// (b, h) and walks the key blocks of 64; Q (pre-scaled), K and V are staged
// in shared memory as float32, K rows at an odd stride so that the 32
// lanes, each on its own key, hit 32 banks; each lane accumulates out dims
// lane, lane + 32, ... of its warp's 8 rows in registers. Explicit fmaf
// keeps the products fused although the library is built with
// -fmad=false.
#include <cuda.h>  // CUtensorMap and its enums; no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Strides {
  long long b, s, h;
};

// ---------------------------------------------------------------------------
// float32: the CUDA cores
// ---------------------------------------------------------------------------
constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per block step
constexpr int WARPS = 8;
constexpr int ROWS = BQ / WARPS;  // rows per warp

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

template <int DCH>
__global__ void __launch_bounds__(WARPS * 32)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const int* __restrict__ kv_len,
                           float* __restrict__ o,
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

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;

  for (int e = tid; e < BQ * hd; e += WARPS * 32) {
    const int r = e / hd, d = e - r * hd;
    const int i = q0 + r;
    Qs[e] = i < Sq ? qb[i * qs.s + d] * scale : 0.f;
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
      Ks[j * kstride + d] = in ? kb[kp * ks.s + d] : 0.f;
      Vs[e] = in ? vb[kp * vs.s + d] : 0.f;
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
    float* orow = o + b * os.b + i * os.s + h * os.h;
#pragma unroll
    for (int c = 0; c < DCH; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) orow[d] = acc[r][c] / inv;
    }
  }
}

template <int DCH>
int launch_f32(const void* q, const void* k, const void* v,
               const int* kv_len, void* o, int B, int H, int Hkv, int Sq,
               int Sk, int hd, Strides qs, Strides ks, Strides vs, Strides os,
               int causal, int q_offset, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)BQ * hd + (size_t)BK * (hd | 1) +
                       (size_t)BK * hd + (size_t)WARPS * ROWS * BK);
  auto kern = flash_attention_kernel<DCH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, WARPS * 32, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, kv_len, (float*)o,
      H, Hkv, Sq, Sk, hd, qs, ks, vs, os, causal, q_offset,
      (float)std::pow((double)hd, -0.5));  // as the reference's hd ** -0.5
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: both products on the tensor cores (wgmma)
// ---------------------------------------------------------------------------
//
// Shared-memory tiles are 64 rows of HDP bf16 (hd zero-padded to a multiple
// of 16). TMA fills them with boxes whose rows are 128 bytes (64 columns,
// the 128-byte swizzle) where HDP allows, and 32 bytes (16 columns, the
// 32-byte swizzle) for the rest: at hd 80, one box of 64 columns and one
// of 16. A tile holds NA = HDP / 64 regions of 64 rows x 128 bytes, then
// NB = HDP % 64 / 16 slices of 64 rows x 32 bytes, each in the layout that
// TMA writes and wgmma reads:
//
//   region a, column c:  a * 8192 + r * 128 + 16 * ((c / 8 % 8) ^ (r % 8))
//   slice j, column c:   NA * 8192 + j * 2048 + r * 32
//                        + 16 * ((c / 8 % 2) ^ (r / 4 % 2))
//
// plus (c % 8) * 2. Padding every row to 128 bytes would add 60 % to both
// products at hd 80, and 32-byte rows alone (or the unswizzled 16-byte
// core-matrix layout) cost TMA one request per 32 (16) bytes: the loads of
// K and V then took most of the kernel's time. For a K-major operand (Q,
// and K in Q.K^T) one k16 step is 32 bytes of a row: 8-row groups lie 1024
// bytes apart (SBO) in a region and 256 in a slice. The same V tile is the
// N-major B operand of P.V (transpose bit set): 64 output columns per
// region with 8-key groups 1024 bytes apart, and 16 per slice with 8-key
// groups 256 bytes apart and slices 2048 (LBO).

constexpr int WROWS = 64;             // query rows per consumer warpgroup
constexpr int KT = 64;                // keys per K/V tile
constexpr int REGION = KT * 128;      // bytes of a 64-column region
constexpr int SLICE = KT * 32;        // bytes of a 16-column slice
constexpr uint64_t SW128 = 1, SW32 = 3;  // wgmma layout types
constexpr float LOG2E = 1.4426950408889634f;
constexpr int SMEM_LIMIT = 227 * 1024;
// (b, h) pairs whose query blocks run together: at the serve shape 32
// heads' K and V (10 MB) stay in L2 while all their query blocks read
// them. Walking every head's heaviest block first instead read K and V
// from device memory again for each query block.
constexpr int HGROUP = 32;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo, uint64_t type) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (type << 62);
}

// Descriptor of k16 step kk (columns 16 kk ..) of a K-major 64-row tile.
template <int HDP>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  constexpr int NA = HDP / 64;
  if (kk < 4 * NA)
    return wgmma_desc(tile + (kk / 4) * REGION + (kk % 4) * 32, 16, 1024,
                      SW128);
  return wgmma_desc(tile + NA * REGION + (kk - 4 * NA) * SLICE, 16, 256,
                    SW32);
}

// Byte offset in a tile of row r's 16-byte piece that starts at column c.
template <int HDP>
__device__ __forceinline__ uint32_t piece_offset(int r, int c) {
  constexpr int NA = HDP / 64;
  if (c < 64 * NA)
    return (c >> 6) * REGION + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4);
  const int cs = c - 64 * NA;
  return NA * REGION + (cs >> 4) * SLICE + r * 32 +
         ((((cs >> 3) & 1) ^ ((r >> 2) & 1)) << 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Tells the compiler that the registers change here, so that no read of an
// accumulator moves above the wait of the asynchronous product writing it.
template <int N>
__device__ __forceinline__ void touch(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}


__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's generic-proxy writes to shared memory (cp.async and
// plain stores) visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void st_shared_v4(uint32_t dst, uint32_t a,
                                             uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// One TMA box of a (hd, S, heads, B) tensor map, 64 rows from `row` at
// column `col`; coordinates past the tensor's ends read as zero.
// Completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int col, int row,
                                        int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head),
      "r"(batch), "r"(bar)
      : "memory");
}

// Tensor maps of q, k and v for the TMA loads (unused when tma is 0): wide
// boxes of 64 columns in the 128-byte swizzle, narrow ones of 16 in the
// 32-byte swizzle.
struct Maps {
  CUtensorMap q, k, v, q16, k16, v16;
};

// Loads rows row0 .. row0 + 63 of one tensor into a tile: its regions, then
// its slices.
template <int HDP>
__device__ __forceinline__ void tma_tile(uint32_t tile, const CUtensorMap* wide,
                                         const CUtensorMap* narrow,
                                         uint32_t bar, int row0, int head,
                                         int batch) {
  constexpr int NA = HDP / 64, NB = HDP % 64 / 16;
  for (int a = 0; a < NA; ++a)
    tma_box(tile + a * REGION, wide, bar, 64 * a, row0, head, batch);
  for (int j = 0; j < NB; ++j)
    tma_box(tile + NA * REGION + j * SLICE, narrow, bar, 64 * NA + 16 * j,
            row0, head, batch);
}

// 2^x on the special-function unit; 2^-inf = 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copies rows row0 .. row0 + 63 of a (rows, hd) bf16 matrix (row stride
// `rs` elements, unit column stride) into a tile in the layout above, as
// TMA would: rows at or past `limit`, and columns at or past hd, read as
// zero. Sixteen consecutive threads take two 16-byte pieces of a row for 8
// rows, so that 32 bytes of a row come from one instruction and each
// 8-thread phase of the shared-memory store hits 8 distinct 16-byte bank
// groups. `vec`: the base and the row stride allow
// 16-byte copies; otherwise (or for a piece that hd cuts) the thread reads
// element by element.
template <int HDP>
__device__ __forceinline__ void load_tile(uint32_t tile,
                                          const __nv_bfloat16* g, long long rs,
                                          int row0, int limit, int hd,
                                          bool vec, int t, int nthreads) {
  constexpr int PIECES = KT * HDP / 8;
  for (int e = t; e < PIECES; e += nthreads) {
    const int rest = e >> 4;
    const int r = ((rest & 7) << 3) | (e & 7);
    const int c = (((rest >> 3) << 1) | ((e >> 3) & 1)) << 3;  // first column
    const uint32_t dst = tile + piece_offset<HDP>(r, c);
    const int row = row0 + r;
    if (row >= limit || c >= hd) {
      st_shared_v4(dst, 0u, 0u, 0u, 0u);
    } else if (vec && c + 8 <= hd) {
      cp_async16(dst, g + row * rs + c);
    } else {
      const __nv_bfloat16* src = g + row * rs;
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float lo = c + 2 * i < hd ? __bfloat162float(src[c + 2 * i])
                                        : 0.f;
        const float hi = c + 2 * i + 1 < hd
                             ? __bfloat162float(src[c + 2 * i + 1])
                             : 0.f;
        w[i] = pack_bf16(lo, hi);  // exact: the values are bf16 already
      }
      st_shared_v4(dst, w[0], w[1], w[2], w[3]);
    }
  }
}

// D (64 x 64, float32) (+)= A (64 x 16) . B (64 x 16)^T, both bf16 in
// shared memory and K-major; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 16, float32) += A (64 x 16, bf16, registers) . B (16 x 16,
// bf16, shared memory, N-major: the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 32, float32) += A (64 x 16, bf16, registers) . B (16 x 32,
// bf16, shared memory, N-major: the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 48, float32) += A (64 x 16, bf16, registers) . B (16 x 48,
// bf16, shared memory, N-major: the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n48(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, float32) += A (64 x 16, bf16, registers) . B (16 x 64,
// bf16, shared memory, N-major: the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// P.V for k16 step kk (keys 16 kk ..): the output columns in chunks of 64
// (one per region) and one of 16, 32 or 48 (the slices), each one wgmma
// with A = P from registers.
template <int HDP, int C0 = 0>
__device__ __forceinline__ void pv_step(float* o, const uint32_t* a,
                                        uint32_t vtile, int kk) {
  constexpr int NA = HDP / 64;
  if constexpr (C0 < HDP) {
    constexpr int W = HDP - C0 < 64 ? HDP - C0 : 64;
    if constexpr (W == 64) {
      wgmma_rs_n64(o + C0 / 2, a,
                   wgmma_desc(vtile + (C0 / 64) * REGION + kk * 16 * 128,
                              REGION, 1024, SW128));
    } else {
      const uint64_t db = wgmma_desc(vtile + NA * REGION + kk * 16 * 32,
                                     SLICE, 256, SW32);
      if constexpr (W == 48) wgmma_rs_n48(o + C0 / 2, a, db);
      if constexpr (W == 32) wgmma_rs_n32(o + C0 / 2, a, db);
      if constexpr (W == 16) wgmma_rs_n16(o + C0 / 2, a, db);
    }
    pv_step<HDP, C0 + 64>(o, a, vtile, kk);
  }
}

// One block: one consumer warpgroup (warps 0-3) of 64 query rows and one
// producer warp (warp 4) that keeps a ring of ST K/V tiles in flight. At
// the serve shape, one consumer and two stages (50 KB) let three blocks
// share an SM, and ran faster than blocks of 2 or 3 consumer warpgroups
// sharing each tile, with 2 to 6 stages, which hold an SM alone; one
// consumer also leaves a thread up to 255 registers, so no head dim
// spills.
template <int HDP, int ST>
__global__ void __launch_bounds__(160, 1)
    flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const int* __restrict__ kv_len,
                      __nv_bfloat16* __restrict__ o, int B, int H, int Hkv,
                      int Sq, int Sk, int hd, Strides qs, Strides ks,
                      Strides vs, Strides os, int causal, int q_offset,
                      float scale, int vec, int tma,
                      const __grid_constant__ Maps maps) {
  constexpr int TILE = KT * HDP * 2;  // bytes of one 64-row tile
  extern __shared__ __align__(1024) unsigned char smem_bytes[];
  const uint32_t sQ = smem_u32(smem_bytes);
  const uint32_t sK = sQ + TILE;
  const uint32_t sV = sK + ST * TILE;
  const uint32_t full = sV + ST * TILE;   // ST mbarriers: tile landed
  const uint32_t empty = full + 8 * ST;   // ST mbarriers: tile consumed
  const uint32_t qbar = empty + 8 * ST;   // Q landed (TMA)

  // The grid: groups of HGROUP (b, h) pairs, one after the other, so that
  // the blocks in flight share their K and V through L2; inside a group the
  // query blocks from the last (the heaviest under the causal mask) to the
  // first, every (b, h) of the group at each.
  const int nqb = (Sq + WROWS - 1) / WROWS;
  const int grp = blockIdx.x / (HGROUP * nqb);
  const int rem = blockIdx.x - grp * HGROUP * nqb;
  const int gsize = min(HGROUP, B * H - grp * HGROUP);
  const int qb = nqb - 1 - rem / gsize;
  const int bh = grp * HGROUP + rem % gsize;
  const int h = bh % H, b = bh / H;
  const int hk = h / (H / Hkv);
  const int q0 = qb * WROWS;

  const int kvl = kv_len ? kv_len[b] : Sk;
  // Keys past kend are masked for every row of the block; with kv_len >= 1
  // each row has key 0 valid, so skipping them drops only exp(-1e30 - m) = 0.
  int kend = Sk;
  if (kvl >= 1) {
    kend = min(kend, kvl);
    if (causal) kend = min(kend, q_offset + min(q0 + WROWS, Sq));
  }
  const int ntiles = (kend + KT - 1) / KT;
  // A tile needs the mask when it crosses Sk or kv_len, or the causal
  // diagonal of the block's first row.
  const int mask_from = min(min(Sk, kvl), causal ? q_offset + q0 + 1 : Sk);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, tma ? 1 : 32);
      mbar_init(empty + 8 * s, 128);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128 && tma) {
    // Producer warp, TMA: one thread loads the Q tile, then tile t into
    // stage t % ST once the consumers have released the tile that was
    // there.
    if (tid == 128) {
      mbar_expect_tx(qbar, TILE);
      tma_tile<HDP>(sQ, &maps.q, &maps.q16, qbar, q0, h, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % ST;
        if (t >= ST) mbar_wait(empty + 8 * s, ((t / ST) - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * TILE);
        tma_tile<HDP>(sK + s * TILE, &maps.k, &maps.k16, full + 8 * s,
                      t * KT, hk, b);
        tma_tile<HDP>(sV + s * TILE, &maps.v, &maps.v16, full + 8 * s,
                      t * KT, hk, b);
      }
    }
    return;
  }
  if (tid >= 128) {
    // Producer warp, cp.async (strides that TMA does not take): the same
    // ring; a tile is announced once this lane's copies of it are complete
    // and fenced for the async proxy.
    const int lane = tid & 31;
    const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
    const __nv_bfloat16* vb = v + b * vs.b + hk * vs.h;
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % ST;
      if (t >= ST) mbar_wait(empty + 8 * s, ((t / ST) - 1) & 1);
      load_tile<HDP>(sK + s * TILE, kb, ks.s, t * KT, Sk, hd, vec & 2, lane,
                     32);
      load_tile<HDP>(sV + s * TILE, vb, vs.s, t * KT, Sk, hd, vec & 4, lane,
                     32);
      cp_async_commit();
      if (t >= 1) {
        cp_async_wait<1>();
        fence_proxy_async();
        mbar_arrive(full + 8 * ((t - 1) % ST));
      }
    }
    cp_async_wait<0>();
    fence_proxy_async();
    mbar_arrive(full + 8 * ((ntiles - 1) % ST));
    return;
  }

  // The consumer warpgroup. Thread (warp w, lane l) holds rows r0 = q0 +
  // 16 w + l / 4 and r0 + 8, and in each 8-column block j of an
  // accumulator the columns 8 j + 2 (l % 4) and the next: registers 4 j,
  // 4 j + 1 (row r0) and 4 j + 2, 4 j + 3 (row r0 + 8).
  const int lane = tid & 31;
  const int r0 = q0 + ((tid >> 5) << 4) + (lane >> 2);
  const int r1 = r0 + 8;
  const int cq = 2 * (lane & 3);
  if (tma) {
    mbar_wait(qbar, 0);
  } else {
    load_tile<HDP>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, Sq, hd, vec & 1,
                   tid, 128);
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
    named_sync(1, 128);
  }

  // S = Q K^T for the tile in stage st: hd / 16 k16 steps, unscaled bf16
  // in, float32 out. Issued, not waited for.
  auto issue_qk = [&](float* sc, int st) {
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      wgmma_ss_n64(sc, kmajor_desc<HDP>(sQ, kk),
                   kmajor_desc<HDP>(sK + st * TILE, kk), kk > 0);
    wgmma_commit();
  };
  // O += P V for the tile in stage st over its 4 k16 steps of keys.
  auto issue_pv = [&](float* o, const uint32_t* p, int st) {
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      pv_step<HDP>(o, p + 4 * kk, sV + st * TILE, kk);
    wgmma_commit();
  };

  // Scores and row maxima are kept in base 2: s * scale * log2(e), so that
  // exp(s - m) is one ex2. A masked key scores -1e30 all the same (p = 0
  // next to any valid key; 1 when the row has none).
  const float scale2 = scale * LOG2E;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  // The online softmax of the scores of keys k0 ..: scales and masks sc,
  // moves the row maxima, adds this thread's share of the row sums to l
  // (float32 p, before the bf16 rounding; the four threads of a row add
  // theirs at the end) and packs p as bf16 pairs into the A fragment of
  // P.V. Returns the factors by which O must be rescaled.
  auto softmax = [&](float* sc, int k0, uint32_t* pa, float& al0,
                     float& al1) {
    const bool masked = k0 + KT > mask_from;
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = sc[i] * scale2;
      if (masked) {
        const int kp = k0 + 8 * (i >> 2) + cq + (i & 1);
        const int qp = q_offset + ((i & 2) ? r1 : r0);
        const bool valid = kp < kvl && (!causal || qp >= kp);
        x = kp >= Sk ? -INFINITY : (valid ? x : NEG_INF);
      }
      sc[i] = x;
      if (i & 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    al0 = ex2(m0 - mn0);
    al1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const float mn = (i & 2) ? mn1 : mn0;
      const float lo = ex2(sc[i] - mn);
      const float hi = ex2(sc[i + 1] - mn);
      if (i & 2) ps1 += lo + hi; else ps0 += lo + hi;
      pa[i / 2] = pack_bf16(lo, hi);
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
  };

  float oacc[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) oacc[i] = 0.f;
  float sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  uint32_t pa[16];
  for (int t = 0; t < ntiles; ++t) {
    const int st = t % ST;
    mbar_wait(full + 8 * st, (t / ST) & 1);
    touch<32>(sc);
    wgmma_fence();
    issue_qk(sc, st);
    wgmma_wait_all();
    touch<32>(sc);
    float al0, al1;
    softmax(sc, t * KT, pa, al0, al1);
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) oacc[i] *= (i & 2) ? al1 : al0;
    touch<HDP / 2>(oacc);
    wgmma_fence();
    issue_pv(oacc, pa, st);
    wgmma_wait_all();
    touch<HDP / 2>(oacc);
    mbar_arrive(empty + 8 * st);
  }


#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(FULL, l0, off);
    l1 += __shfl_xor_sync(FULL, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int i = 0; i < HDP / 2; i += 2) {
    const int row = (i & 2) ? r1 : r0;
    const int col = 8 * (i >> 2) + cq;
    if (row >= Sq || col >= hd) continue;
    const float dv = (i & 2) ? d1 : d0;
    __nv_bfloat16* dst = o + b * os.b + row * os.s + h * os.h + col;
    if (col + 1 < hd && (hd & 1) == 0) {
      *reinterpret_cast<__nv_bfloat162*>(dst) =
          __floats2bfloat162_rn(oacc[i] / dv, oacc[i + 1] / dv);
    } else {
      dst[0] = __float2bfloat16(oacc[i] / dv);
      if (col + 1 < hd) dst[1] = __float2bfloat16(oacc[i + 1] / dv);
    }
  }
}

// Stages of the K/V ring (see flash_bf16_kernel).
constexpr int STAGES = 2;

template <int HDP>
int launch_bf16(const void* q, const void* k, const void* v,
                const int* kv_len, void* o, int B, int H, int Hkv, int Sq,
                int Sk, int hd, Strides qs, Strides ks, Strides vs,
                Strides os, int causal, int q_offset, int vec, int tma,
                const Maps& maps, cudaStream_t stream) {
  constexpr int TILE = KT * HDP * 2;
  static_assert((1 + 2 * STAGES) * TILE + 1024 <= SMEM_LIMIT,
                "the Q tile and the K/V ring fit in shared memory");
  const size_t smem = (size_t)(1 + 2 * STAGES) * TILE + 16 * STAGES + 8;
  auto kern = flash_bf16_kernel<HDP, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nqb = (Sq + WROWS - 1) / WROWS;
  kern<<<nqb * B * H, 160, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, kv_len, (__nv_bfloat16*)o, B, H, Hkv, Sq, Sk,
      hd, qs, ks, vs, os, causal, q_offset,
      (float)std::pow((double)hd, -0.5), vec, tma, maps);
  return (int)cudaGetLastError();
}
int dispatch_f32(const void* q, const void* k, const void* v,
                 const int* kv_len, void* o, int B, int H, int Hkv, int Sq,
                 int Sk, int hd, Strides qs, Strides ks, Strides vs,
                 Strides os, int causal, int q_offset, cudaStream_t s) {
  switch ((hd + 31) / 32) {
#define CASE(n)                                                               \
  case n:                                                                     \
    return launch_f32<n>(q, k, v, kv_len, o, B, H, Hkv, Sq, Sk, hd, qs, ks,  \
                         vs, os, causal, q_offset, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p, Strides st) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && st.b % 8 == 0 &&
         st.s % 8 == 0 && st.h % 8 == 0;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint so that the
// library needs no -lcuda; null where it is not available.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// Whether TMA can describe the (B, S, heads, hd) bf16 tensor at p: a
// 16-byte-aligned base and strides that are positive multiples of 16 bytes
// below 2^40.
bool tma_takes(const void* p, Strides st) {
  constexpr long long LIM = 1LL << 39;  // elements
  return aligned16(p, st) && st.s > 0 && st.h > 0 && st.b > 0 &&
         st.s < LIM && st.h < LIM && st.b < LIM;
}

// Encodes the map of that tensor (see tma_takes) with boxes of `cols`
// columns (64: the 128-byte swizzle, 16: the 32-byte one) x 64 rows; false
// when the driver has no encoder or refuses the map.
bool tensor_map(CUtensorMap* map, const void* p, int hd, int S, int heads,
                int B, Strides st, int cols) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)KT, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int dispatch_bf16(const void* q, const void* k, const void* v,
                  const int* kv_len, void* o, int B, int H, int Hkv, int Sq,
                  int Sk, int hd, Strides qs, Strides ks, Strides vs,
                  Strides os, int causal, int q_offset, cudaStream_t s) {
  const int vec = (aligned16(q, qs) ? 1 : 0) | (aligned16(k, ks) ? 2 : 0) |
                  (aligned16(v, vs) ? 4 : 0);
  Maps maps{};
  const int hdp = (hd + 15) / 16 * 16;
  const bool wide = hdp >= 64, narrow = hdp % 64 != 0;  // the maps it needs
  const int tma = tma_takes(q, qs) && tma_takes(k, ks) && tma_takes(v, vs);
  if (tma &&
      !((!wide || (tensor_map(&maps.q, q, hd, Sq, H, B, qs, 64) &&
                   tensor_map(&maps.k, k, hd, Sk, Hkv, B, ks, 64) &&
                   tensor_map(&maps.v, v, hd, Sk, Hkv, B, vs, 64))) &&
        (!narrow || (tensor_map(&maps.q16, q, hd, Sq, H, B, qs, 16) &&
                     tensor_map(&maps.k16, k, hd, Sk, Hkv, B, ks, 16) &&
                     tensor_map(&maps.v16, v, hd, Sk, Hkv, B, vs, 16)))))
    return (int)cudaErrorNotSupported;  // no other route for these strides
  switch ((hd + 15) / 16) {
#define CASE(n)                                                             \
  case n:                                                                   \
    return launch_bf16<16 * n>(                                             \
        q, k, v, kv_len, o, B, H, Hkv, Sq, Sk, hd, qs, ks, vs, os, causal,  \
        q_offset, vec, tma, maps, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, H, hd), k and v (B, Sk, Hkv, hd), out (B, Sq, H, hd), all of
// dtype 0 = float32 or 1 = bfloat16, read through the given element
// strides of their first three dims (the last dim has stride 1); kv_len
// (B,) int32, or null for every key valid. hd is at most 256. float32 runs
// the CUDA-core kernel, bfloat16 the wgmma kernel.
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
    return dispatch_f32(q, k, v, kl, o, B, H, Hkv, Sq, Sk, hd, qs, ks, vs,
                        os, causal, q_offset, s);
  if (dtype == 1)
    return dispatch_bf16(q, k, v, kl, o, B, H, Hkv, Sq, Sk, hd, qs, ks, vs,
                         os, causal, q_offset, s);
  return (int)cudaErrorInvalidValue;
}
