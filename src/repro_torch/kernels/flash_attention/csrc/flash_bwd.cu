// FlashAttention backward for Hopper (sm_90a): bf16 in, f32 accumulation and
// f32 out.
//
// Replaces the TPU kernels of repro/kernels/flash_attention/kernel.py:
//   flash_dkv (_dkv_kernel) -> flash_dkv_launch
//   flash_dq  (_dq_kernel)  -> flash_dq_launch
// Layout (B, H, S, D), row-major, as flash_fwd.cu, with D in {64, 112, 128}
// (every loop over D runs D / 16 k-steps and D / 8 n-tiles, so 112 needs no
// padding: 7 and 14).  Inputs q, k, v, dO in
// bf16, the forward's log-sum-exp and delta = rowsum(dO * O) (B, Hq, Sq) in
// f32.  Outputs dK, dV (B, Hkv, Skv, D) and dQ (B, Hq, Sq, D) in f32, the
// Pallas kernels' output type.  GQA: query head h reads KV head
// h / (Hq / Hkv); dK and dV of a KV head sum over the Hq / Hkv query heads of
// its group.
//
// Two kernels, as the TPU design has, and no atomics: every output element
// is summed by one thread in a fixed order, so the result does not depend on
// the order in which blocks run.
//   flash_dkv: one CTA per (b, KV head, 64-key block) holds its K and V tile
//     in shared memory and walks the query heads of its group and, within
//     each, the 64-row query blocks it can see (the block test of
//     flash_fwd.cu).  Per query block: S^T = K Q^T * scale, P^T = exp(S^T -
//     LSE), dV += P^T dO, dP^T = V dO^T, dS^T = P^T o (dP^T - delta),
//     dK += dS^T Q; dK is scaled once at the end.
//   flash_dq: one CTA per (b, query head, 64-row query block) walks the key
//     blocks it can see of its KV head: S = Q K^T * scale, P = exp(S - LSE),
//     dP = dO V^T, dS = P o (dP - delta), dQ += dS K; dQ scaled at the end.
// Each of the 4 warps owns 16 rows of the accumulator (keys in flash_dkv,
// queries in flash_dq), kept in f32 registers for the whole CTA; the score
// tiles are taken 32 columns at a time, so that a thread holds 2 x 64
// (flash_dkv, D = 128) or 64 accumulator floats plus 2 x 16 of scores.
//
// What bounds it: operations.  At the training shape (B=2, Hq=16, Hkv=8,
// S=4096, D=128, causal) each causal pair costs 8 D tensor-core operations in
// flash_dkv (four products) and 6 D in flash_dq (three), 2.2e11 and 1.6e11
// in all (0.28 and 0.21 ms at 989 TFLOP/s bf16), against about 100 MB of
// bytes (0.03 ms at 3.35 TB/s).  So every product runs on the tensor cores:
// mma.sync m16n8k16 bf16 -> f32 through inline PTX, operands read from
// shared memory (row-major tiles and transposed copies, rows padded by 8
// bf16 so the fragment loads hit 32 distinct banks).  Simple on purpose: no
// cp.async pipelining, no wgmma or TMA.
//
// Numerics follow the Pallas kernels: scores scaled in f32; masked pairs set
// to NEG_INF = -1e30 by a select; P = exp(S - LSE) in f32; blocks that no
// pair can see are skipped whole.  One difference: P and dS are rounded to
// bf16 before their tensor-core products (dV += P^T dO, dK += dS^T Q,
// dQ += dS K), as flash_fwd.cu rounds P; the Pallas body and the plain
// version keep them in f32.  Query rows past Sq get LSE = +inf (so P = 0)
// and delta = 0; keys past Skv get S = -inf in flash_dq (so P = dS = 0), and
// their rows of dK and dV are not written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash_bwd {

constexpr int kBlock = 64;      // keys of a flash_dkv CTA, query rows of a flash_dq CTA
constexpr int kCols = 32;       // score columns taken at a time
constexpr int kThreads = 128;   // 4 warps, 16 accumulator rows each
constexpr int kTStride = kBlock + 8;  // row stride of a transposed (D, 64) tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as bf16x2: lo in the low half (the lower column index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy rows [r0, r0 + kBlock) of a (rows, D) matrix into s (kBlock, D + 8),
// zero past `rows`.  16-byte chunks; consecutive threads take consecutive
// chunks of a row.
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* s, const __nv_bfloat16* g,
                                          int r0, int rows) {
  constexpr int kStride = D + 8;
  constexpr int kPerRow = D / 8;
  for (int c = threadIdx.x; c < kBlock * kPerRow; c += kThreads) {
    const int row = c / kPerRow;
    const int col = (c % kPerRow) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + row < rows) val = *reinterpret_cast<const uint4*>(g + (size_t)(r0 + row) * D + col);
    *reinterpret_cast<uint4*>(s + row * kStride + col) = val;
  }
}

// Copy rows [r0, r0 + kBlock) of a (rows, D) matrix transposed into s
// (D, kBlock + 8), zero past `rows`.
template <int D>
__device__ __forceinline__ void load_rows_transposed(__nv_bfloat16* s, const __nv_bfloat16* g,
                                                     int r0, int rows) {
  for (int c = threadIdx.x; c < kBlock * (D / 8); c += kThreads) {
    const int row = c % kBlock;
    const int col = (c / kBlock) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + row < rows) val = *reinterpret_cast<const uint4*>(g + (size_t)(r0 + row) * D + col);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i) s[(col + i) * kTStride + row] = e[i];
  }
}

// The A fragment (16 x 16, row-major) of rows [row0, row0 + 16), columns
// [col0, col0 + 16) of a row-major tile with row stride `stride`.
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* s, int stride,
                                       int row0, int col0) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* p = s + (row0 + (lane >> 2)) * stride + col0 + 2 * (lane & 3);
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * stride);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * stride + 8);
}

// acc[n] (16 x 8 tiles, n < N) += A (16 x 16) B, where B (16 x 8n) is read as
// rows [row0 + 8n, row0 + 8n + 8) of the n-major tile s: B[k][j] =
// s[(row0 + j) * stride + col0 + k].
template <int N>
__device__ __forceinline__ void mma_row(float acc[][4], const uint32_t a[4],
                                        const __nv_bfloat16* s, int stride, int row0,
                                        int col0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const __nv_bfloat16* p = s + (row0 + n * 8 + (lane >> 2)) * stride + col0 + 2 * (lane & 3);
    mma_bf16_16816(acc[n], a, ld32(p), ld32(p + 8));
  }
}

// The (16 x 16) A fragment of k-step kk from (16 x 8) accumulator tiles
// c[2 kk], c[2 kk + 1], rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float c0[4], const float c1[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(
    const __nv_bfloat16* __restrict__ q,   // (B, Hq, Sq, D)
    const __nv_bfloat16* __restrict__ k,   // (B, Hkv, Skv, D)
    const __nv_bfloat16* __restrict__ v,   // (B, Hkv, Skv, D)
    const __nv_bfloat16* __restrict__ dout,  // (B, Hq, Sq, D)
    const float* __restrict__ lse,         // (B, Hq, Sq)
    const float* __restrict__ delta,       // (B, Hq, Sq)
    float* __restrict__ dk,                // (B, Hkv, Skv, D)
    float* __restrict__ dv,                // (B, Hkv, Skv, D)
    int hq, int hkv, int sq, int skv, float scale, int causal, int has_window, int window) {
  constexpr int kStride = D + 8;
  constexpr int kSteps = D / 16;   // k-steps of the products over D
  constexpr int kDTiles = D / 8;   // n-tiles of dK, dV
  constexpr int kNTiles = kCols / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_k = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_v = s_k + kBlock * kStride;
  __nv_bfloat16* s_q = s_v + kBlock * kStride;
  __nv_bfloat16* s_do = s_q + kBlock * kStride;
  __nv_bfloat16* s_qt = s_do + kBlock * kStride;   // (D, kTStride)
  __nv_bfloat16* s_dot = s_qt + D * kTStride;      // (D, kTStride)
  float* s_lse = reinterpret_cast<float*>(s_dot + D * kTStride);
  float* s_delta = s_lse + kBlock;

  const int k0 = blockIdx.x * kBlock;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = hq / hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int j0 = k0 + warp * 16 + (lane >> 2);  // this thread's two keys
  const int j1 = j0 + 8;
  const int k_last = min(k0 + kBlock, skv) - 1;

  load_rows<D>(s_k, k + (size_t)(b * hkv + kvh) * skv * D, k0, skv);
  load_rows<D>(s_v, v + (size_t)(b * hkv + kvh) * skv * D, k0, skv);

  float dk_acc[kDTiles][4], dv_acc[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;
  }

  const int n_qblocks = (sq + kBlock - 1) / kBlock;
  for (int hh = 0; hh < group; ++hh) {
    const size_t row_off = (size_t)(b * hq + kvh * group + hh) * sq;
    for (int qb = 0; qb < n_qblocks; ++qb) {
      const int q0 = qb * kBlock;
      const int q_last = min(q0 + kBlock, sq) - 1;
      // block-level skip, as flash_fwd.cu: no (query, key) pair is visible
      if (causal && k0 > q_last) continue;
      if (has_window && k_last <= q0 - window) continue;

      __syncthreads();  // the previous block is done with s_q, s_do, ...
      load_rows<D>(s_q, q + row_off * D, q0, sq);
      load_rows<D>(s_do, dout + row_off * D, q0, sq);
      load_rows_transposed<D>(s_qt, q + row_off * D, q0, sq);
      load_rows_transposed<D>(s_dot, dout + row_off * D, q0, sq);
      if (threadIdx.x < kBlock) {
        const int i = q0 + threadIdx.x;
        s_lse[threadIdx.x] = i < sq ? lse[row_off + i] : INFINITY;
        s_delta[threadIdx.x] = i < sq ? delta[row_off + i] : 0.f;
      }
      __syncthreads();

#pragma unroll
      for (int c0 = 0; c0 < kBlock; c0 += kCols) {
        // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys x kCols queries
        float st[kNTiles][4], dpt[kNTiles][4];
#pragma unroll
        for (int n = 0; n < kNTiles; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          uint32_t a[4];
          load_a(a, s_k, kStride, warp * 16, kk * 16);
          mma_row<kNTiles>(st, a, s_q, kStride, c0, kk * 16);
          load_a(a, s_v, kStride, warp * 16, kk * 16);
          mma_row<kNTiles>(dpt, a, s_do, kStride, c0, kk * 16);
        }
        // P^T = exp(S^T - LSE) with the mask; dS^T = P^T o (dP^T - delta)
#pragma unroll
        for (int n = 0; n < kNTiles; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = e < 2 ? j0 : j1;
            const int col = c0 + n * 8 + 2 * t + (e & 1);
            const int qi = q0 + col;
            float x = st[n][e] * scale;
            if ((causal && key > qi) || (has_window && key <= qi - window)) x = kNegInf;
            const float p = expf(x - s_lse[col]);
            st[n][e] = p;
            dpt[n][e] = p * (dpt[n][e] - s_delta[col]);
          }
        }
        // dV += P^T dO and dK += dS^T Q, 16 queries a k-step
#pragma unroll
        for (int kk = 0; kk < kCols / 16; ++kk) {
          uint32_t a[4];
          acc_to_a(a, st[2 * kk], st[2 * kk + 1]);
          mma_row<kDTiles>(dv_acc, a, s_dot, kTStride, 0, c0 + kk * 16);
          acc_to_a(a, dpt[2 * kk], dpt[2 * kk + 1]);
          mma_row<kDTiles>(dk_acc, a, s_qt, kTStride, 0, c0 + kk * 16);
        }
      }
    }
  }

  float* dkb = dk + (size_t)(b * hkv + kvh) * skv * D;
  float* dvb = dv + (size_t)(b * hkv + kvh) * skv * D;
#pragma unroll
  for (int i = 0; i < kDTiles; ++i) {
    const int col = i * 8 + 2 * t;
    if (j0 < skv) {
      *reinterpret_cast<float2*>(dkb + (size_t)j0 * D + col) =
          make_float2(dk_acc[i][0] * scale, dk_acc[i][1] * scale);
      *reinterpret_cast<float2*>(dvb + (size_t)j0 * D + col) =
          make_float2(dv_acc[i][0], dv_acc[i][1]);
    }
    if (j1 < skv) {
      *reinterpret_cast<float2*>(dkb + (size_t)j1 * D + col) =
          make_float2(dk_acc[i][2] * scale, dk_acc[i][3] * scale);
      *reinterpret_cast<float2*>(dvb + (size_t)j1 * D + col) =
          make_float2(dv_acc[i][2], dv_acc[i][3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(
    const __nv_bfloat16* __restrict__ q,   // (B, Hq, Sq, D)
    const __nv_bfloat16* __restrict__ k,   // (B, Hkv, Skv, D)
    const __nv_bfloat16* __restrict__ v,   // (B, Hkv, Skv, D)
    const __nv_bfloat16* __restrict__ dout,  // (B, Hq, Sq, D)
    const float* __restrict__ lse,         // (B, Hq, Sq)
    const float* __restrict__ delta,       // (B, Hq, Sq)
    float* __restrict__ dq,                // (B, Hq, Sq, D)
    int hq, int hkv, int sq, int skv, float scale, int causal, int has_window, int window) {
  constexpr int kStride = D + 8;
  constexpr int kSteps = D / 16;
  constexpr int kDTiles = D / 8;
  constexpr int kNTiles = kCols / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_do = s_q + kBlock * kStride;
  __nv_bfloat16* s_k = s_do + kBlock * kStride;
  __nv_bfloat16* s_v = s_k + kBlock * kStride;
  __nv_bfloat16* s_kt = s_v + kBlock * kStride;  // (D, kTStride)

  const int q0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const size_t row_off = (size_t)(b * hq + h) * sq;
  const __nv_bfloat16* kb = k + (size_t)(b * hkv + kvh) * skv * D;
  const __nv_bfloat16* vb = v + (size_t)(b * hkv + kvh) * skv * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int r0 = q0 + warp * 16 + (lane >> 2);  // this thread's two query rows
  const int r1 = r0 + 8;
  const int q_last = min(q0 + kBlock, sq) - 1;
  const float lse0 = r0 < sq ? lse[row_off + r0] : INFINITY;
  const float lse1 = r1 < sq ? lse[row_off + r1] : INFINITY;
  const float delta0 = r0 < sq ? delta[row_off + r0] : 0.f;
  const float delta1 = r1 < sq ? delta[row_off + r1] : 0.f;

  load_rows<D>(s_q, q + row_off * D, q0, sq);
  load_rows<D>(s_do, dout + row_off * D, q0, sq);

  float dq_acc[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i) dq_acc[i][0] = dq_acc[i][1] = dq_acc[i][2] = dq_acc[i][3] = 0.f;

  const int n_kblocks = (skv + kBlock - 1) / kBlock;
  for (int kt = 0; kt < n_kblocks; ++kt) {
    const int k0 = kt * kBlock;
    const int k_last = min(k0 + kBlock, skv) - 1;
    if (causal && k0 > q_last) continue;
    if (has_window && k_last <= q0 - window) continue;

    __syncthreads();  // the previous tile is done with s_k, s_v, s_kt
    load_rows<D>(s_k, kb, k0, skv);
    load_rows<D>(s_v, vb, k0, skv);
    load_rows_transposed<D>(s_kt, kb, k0, skv);
    __syncthreads();

#pragma unroll
    for (int c0 = 0; c0 < kBlock; c0 += kCols) {
      // S = Q K^T and dP = dO V^T for the warp's 16 rows x kCols keys
      float s[kNTiles][4], dp[kNTiles][4];
#pragma unroll
      for (int n = 0; n < kNTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t a[4];
        load_a(a, s_q, kStride, warp * 16, kk * 16);
        mma_row<kNTiles>(s, a, s_k, kStride, c0, kk * 16);
        load_a(a, s_do, kStride, warp * 16, kk * 16);
        mma_row<kNTiles>(dp, a, s_v, kStride, c0, kk * 16);
      }
      // dS = P o (dP - delta), P = exp(S - LSE) with the mask
#pragma unroll
      for (int n = 0; n < kNTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? r0 : r1;
          const int key = k0 + c0 + n * 8 + 2 * t + (e & 1);
          float x = s[n][e] * scale;
          if (key >= skv) {
            x = -INFINITY;
          } else if ((causal && key > row) || (has_window && key <= row - window)) {
            x = kNegInf;
          }
          const float p = expf(x - (e < 2 ? lse0 : lse1));
          s[n][e] = p * (dp[n][e] - (e < 2 ? delta0 : delta1));
        }
      }
      // dQ += dS K, 16 keys a k-step
#pragma unroll
      for (int kk = 0; kk < kCols / 16; ++kk) {
        uint32_t a[4];
        acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
        mma_row<kDTiles>(dq_acc, a, s_kt, kTStride, 0, c0 + kk * 16);
      }
    }
  }

  float* dqb = dq + row_off * D;
#pragma unroll
  for (int i = 0; i < kDTiles; ++i) {
    const int col = i * 8 + 2 * t;
    if (r0 < sq)
      *reinterpret_cast<float2*>(dqb + (size_t)r0 * D + col) =
          make_float2(dq_acc[i][0] * scale, dq_acc[i][1] * scale);
    if (r1 < sq)
      *reinterpret_cast<float2*>(dqb + (size_t)r1 * D + col) =
          make_float2(dq_acc[i][2] * scale, dq_acc[i][3] * scale);
  }
}

template <int D>
constexpr int dkv_smem_bytes() {
  return (4 * kBlock * (D + 8) + 2 * D * kTStride) * 2 + 2 * kBlock * 4;
}

template <int D>
constexpr int dq_smem_bytes() {
  return (4 * kBlock * (D + 8) + D * kTStride) * 2;
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, float* dk, float* dv, int batch, int hq, int hkv, int sq,
               int skv, float scale, int causal, int has_window, int window,
               cudaStream_t stream) {
  constexpr int kSmem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_dkv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((skv + kBlock - 1) / kBlock, hkv, batch);
  flash_dkv_kernel<D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse,
      delta, dk, dv, hq, hkv, sq, skv, scale, causal, has_window, window);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, float* dq, int batch, int hq, int hkv, int sq, int skv,
              float scale, int causal, int has_window, int window, cudaStream_t stream) {
  constexpr int kSmem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBlock - 1) / kBlock, hq, batch);
  flash_dq_kernel<D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse,
      delta, dq, hq, hkv, sq, skv, scale, causal, has_window, window);
  return (int)cudaGetLastError();
}

}  // namespace flash_bwd

// dK, dV of attention for bf16 (B, H, S, D) q, k, v, dO with D in {64, 112, 128},
// f32 LSE and delta (B, Hq, Sq); writes f32 dK, dV (B, Hkv, Skv, D).  Returns
// a cudaError_t as int (cudaErrorInvalidValue for any other D).  No
// synchronisation.
extern "C" int flash_dkv_launch(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, float* dk, float* dv,
                                int batch, int hq, int hkv, int sq, int skv, int d, float scale,
                                int causal, int has_window, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 128)
    return flash_bwd::launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, batch, hq, hkv, sq,
                                      skv, scale, causal, has_window, window, st);
  if (d == 112)
    return flash_bwd::launch_dkv<112>(q, k, v, dout, lse, delta, dk, dv, batch, hq, hkv, sq,
                                      skv, scale, causal, has_window, window, st);
  if (d == 64)
    return flash_bwd::launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, batch, hq, hkv, sq,
                                     skv, scale, causal, has_window, window, st);
  return (int)cudaErrorInvalidValue;
}

// dQ of attention for the same inputs; writes f32 dQ (B, Hq, Sq, D).
extern "C" int flash_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* delta, float* dq, int batch,
                               int hq, int hkv, int sq, int skv, int d, float scale, int causal,
                               int has_window, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 128)
    return flash_bwd::launch_dq<128>(q, k, v, dout, lse, delta, dq, batch, hq, hkv, sq, skv,
                                     scale, causal, has_window, window, st);
  if (d == 112)
    return flash_bwd::launch_dq<112>(q, k, v, dout, lse, delta, dq, batch, hq, hkv, sq, skv,
                                     scale, causal, has_window, window, st);
  if (d == 64)
    return flash_bwd::launch_dq<64>(q, k, v, dout, lse, delta, dq, batch, hq, hkv, sq, skv,
                                    scale, causal, has_window, window, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
