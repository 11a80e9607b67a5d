// FlashAttention forward for Hopper (sm_90a): bf16 in, f32 accumulation.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:
//   flash_fwd (_fwd_kernel) -> flash_fwd_launch
// Layout (B, H, S, D), row-major.  Outputs O (B, Hq, Sq, D) in bf16 and the
// log-sum-exp (B, Hq, Sq) in f32.  GQA: query head h reads KV head
// h / (Hq / Hkv), so K and V are never repeated per query head.
//
// What bounds it: operations.  At the serving shape (B=4, Hq=32, Hkv=8,
// S=2048, D=128, causal) a call is ~1.4e11 FLOP (0.14 ms at 989 TFLOP/s
// bf16) against ~168 MB of bytes (0.05 ms at 3.35 TB/s).  So both products
// run on the tensor cores: mma.sync m16n8k16 bf16 -> f32 through inline
// PTX.  A CTA of 4 warps owns kBQ = 64 query rows of one (b, h), 16 rows a
// warp, with its Q fragments in registers; it walks the key tiles of kBK =
// 64 keys through shared memory (K row-major, V transposed, rows padded by
// 8 bf16 so the fragment loads hit 32 distinct banks), and keeps the
// running max m, sum l and the f32 O accumulator in registers (online
// softmax).  The TPU grid's sequential k axis becomes this loop.  Simple
// on purpose: no cp.async double buffering, no wgmma or TMA.
//
// Numerics follow the Pallas kernel: scores scaled in f32; masked pairs
// set to NEG_INF = -1e30 (finite, so (-inf) - (-inf) never occurs); key
// tiles that no query row of the CTA can see are skipped whole (the
// reference's block-level pl.when); P is rounded to bf16 before the PV
// product; O = acc / max(l, 1e-30) and LSE = m + log(max(l, 1e-30)).
// Keys past Skv (a ragged last tile) get -inf, so they add exactly 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int kBQ = 64;         // query rows a CTA
constexpr int kBK = 64;         // keys a tile
constexpr int kThreads = 128;   // 4 warps, 16 query rows each
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

// Copy rows [r0, r0 + kBK) of a (rows, D) matrix into s (kBK, D + 8),
// zero past `rows`.  16-byte chunks; consecutive threads take consecutive
// chunks of a row.
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* s, const __nv_bfloat16* g,
                                          int r0, int rows) {
  constexpr int kStride = D + 8;
  constexpr int kPerRow = D / 8;
  for (int c = threadIdx.x; c < kBK * kPerRow; c += kThreads) {
    const int row = c / kPerRow;
    const int col = (c % kPerRow) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + row < rows) val = *reinterpret_cast<const uint4*>(g + (size_t)(r0 + row) * D + col);
    *reinterpret_cast<uint4*>(s + row * kStride + col) = val;
  }
}

// Copy rows [r0, r0 + kBK) of V (rows, D) transposed into s (D, kBK + 8).
// Consecutive threads take consecutive keys, so the 2-byte stores of a
// warp fall into 16 consecutive words.
template <int D>
__device__ __forceinline__ void load_rows_transposed(__nv_bfloat16* s, const __nv_bfloat16* g,
                                                     int r0, int rows) {
  constexpr int kStride = kBK + 8;
  for (int c = threadIdx.x; c < kBK * (D / 8); c += kThreads) {
    const int row = c % kBK;
    const int col = (c / kBK) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + row < rows) val = *reinterpret_cast<const uint4*>(g + (size_t)(r0 + row) * D + col);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i) s[(col + i) * kStride + row] = e[i];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q,  // (B, Hq, Sq, D)
    const __nv_bfloat16* __restrict__ k,  // (B, Hkv, Skv, D)
    const __nv_bfloat16* __restrict__ v,  // (B, Hkv, Skv, D)
    __nv_bfloat16* __restrict__ o,        // (B, Hq, Sq, D)
    float* __restrict__ lse,              // (B, Hq, Sq)
    int hq, int hkv, int sq, int skv, float scale, int causal, int has_window,
    int window) {
  constexpr int kKStride = D + 8;
  constexpr int kVStride = kBK + 8;
  constexpr int kSteps = D / 16;   // k-steps of Q K^T
  constexpr int kDTiles = D / 8;   // n-tiles of O
  constexpr int kKTiles = kBK / 8; // n-tiles of S
  __shared__ __align__(16) __nv_bfloat16 s_k[kBK * kKStride];
  __shared__ __align__(16) __nv_bfloat16 s_vt[D * kVStride];

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const __nv_bfloat16* qb = q + (size_t)(b * hq + h) * sq * D;
  const __nv_bfloat16* kb = k + (size_t)(b * hkv + kvh) * skv * D;
  const __nv_bfloat16* vb = v + (size_t)(b * hkv + kvh) * skv * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in the group
  const int r0 = q0 + warp * 16 + g;  // this thread's two query rows
  const int r1 = r0 + 8;
  const int q_last = min(q0 + kBQ, sq) - 1;  // the CTA's last real row

  // Q fragments (A operand, row-major 16x16 per k-step), staged through s_k.
  load_rows<D>(s_k, qb, q0, sq);
  __syncthreads();
  uint32_t qa[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const __nv_bfloat16* p = s_k + (warp * 16 + g) * kKStride + kk * 16 + 2 * t;
    qa[kk][0] = ld32(p);
    qa[kk][1] = ld32(p + 8 * kKStride);
    qa[kk][2] = ld32(p + 8);
    qa[kk][3] = ld32(p + 8 * kKStride + 8);
  }
  __syncthreads();

  float acc[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const int n_tiles = (skv + kBK - 1) / kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    const int k_last = min(k0 + kBK, skv) - 1;
    // block-level skip: no (row, key) pair of this tile can be visible
    if (causal && k0 > q_last) continue;
    if (has_window && k_last <= q0 - window) continue;

    load_rows<D>(s_k, kb, k0, skv);
    load_rows_transposed<D>(s_vt, vb, k0, skv);
    __syncthreads();

    // S = Q K^T for the warp's 16 rows x kBK keys.
    float s[kKTiles][4];
#pragma unroll
    for (int n = 0; n < kKTiles; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
      for (int n = 0; n < kKTiles; ++n) {
        const __nv_bfloat16* p = s_k + (n * 8 + g) * kKStride + kk * 16 + 2 * t;
        mma_bf16_16816(s[n], qa[kk], ld32(p), ld32(p + 8));
      }
    }

    // scale, mask, running max
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kKTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * scale;
        if (key >= skv) {
          x = -INFINITY;
        } else if ((causal && key > row) || (has_window && key <= row - window)) {
          x = kNegInf;
        }
        s[n][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = expf(m0 - mx0);
    const float alpha1 = expf(m1 - mx1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < kKTiles; ++n) {
      s[n][0] = expf(s[n][0] - mx0);
      s[n][1] = expf(s[n][1] - mx0);
      s[n][2] = expf(s[n][2] - mx1);
      s[n][3] = expf(s[n][3] - mx1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int i = 0; i < kDTiles; ++i) {
      acc[i][0] *= alpha0;
      acc[i][1] *= alpha0;
      acc[i][2] *= alpha1;
      acc[i][3] *= alpha1;
    }

    // O += P V: the S accumulators become the A operand, 16 keys a step.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int i = 0; i < kDTiles; ++i) {
        const __nv_bfloat16* p = s_vt + (i * 8 + g) * kVStride + kk * 16 + 2 * t;
        mma_bf16_16816(acc[i], pa, ld32(p), ld32(p + 8));
      }
    }
    __syncthreads();  // the next tile overwrites s_k and s_vt
  }

  const float d0 = fmaxf(l0, 1e-30f);
  const float d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = o + (size_t)(b * hq + h) * sq * D;
#pragma unroll
  for (int i = 0; i < kDTiles; ++i) {
    const int col = i * 8 + 2 * t;
    if (r0 < sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * D + col) =
          pack_bf16(acc[i][0] / d0, acc[i][1] / d0);
    if (r1 < sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * D + col) =
          pack_bf16(acc[i][2] / d1, acc[i][3] / d1);
  }
  if (t == 0) {
    float* lb = lse + (size_t)(b * hq + h) * sq;
    if (r0 < sq) lb[r0] = m0 + logf(d0);
    if (r1 < sq) lb[r1] = m1 + logf(d1);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
           int hq, int hkv, int sq, int skv, float scale, int causal, int has_window,
           int window, cudaStream_t stream) {
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, batch);
  flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, hq, hkv,
      sq, skv, scale, causal, has_window, window);
  return (int)cudaGetLastError();
}

}  // namespace flash

// O, LSE = attention(Q, K, V) for bf16 (B, H, S, D) tensors with D in
// {64, 128}; returns a cudaError_t as int (cudaErrorInvalidValue for any
// other D).  No synchronisation.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                float* lse, int batch, int hq, int hkv, int sq, int skv,
                                int d, float scale, int causal, int has_window, int window,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 128)
    return flash::launch<128>(q, k, v, o, lse, batch, hq, hkv, sq, skv, scale, causal,
                              has_window, window, st);
  if (d == 64)
    return flash::launch<64>(q, k, v, o, lse, batch, hq, hkv, sq, skv, scale, causal,
                             has_window, window, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
