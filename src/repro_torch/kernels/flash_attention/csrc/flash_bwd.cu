// FlashAttention backward for Hopper (sm_90a): TMA, an mbarrier ring and
// wgmma; bf16 in, f32 accumulation and f32 out.
//
// Replaces the TPU kernels of repro/kernels/flash_attention/kernel.py:
//   flash_dkv (_dkv_kernel, :267) -> flash_dkv_launch
//   flash_dq  (_dq_kernel,  :364) -> flash_dq_launch
// Layout (B, H, S, D), row-major, as flash_fwd.cu, with D in {16, 32, 64,
// 112, 128} (D = 16 and 32 one zero-filled panel, as in flash_fwd.cu).
// Inputs q, k, v, dO in bf16, the forward's log-sum-exp and delta =
// rowsum(dO * O) (B, Hq, Sq) in f32.  Outputs dK, dV (B, Hkv, Skv, D) and dQ
// (B, Hq, Sq, D) in f32, the Pallas kernels' output type.  GQA: query head
// h reads KV head h / (Hq / Hkv); dK and dV of a KV head sum over the
// Hq / Hkv query heads of its group.
//
// What bounds it: operations.  Each visible (query, key) pair costs 8 D
// tensor-core operations in flash_dkv (four products) and 6 D in flash_dq
// (three): at the training shape (B=2, Hq=16, Hkv=8, S=4096, D=128, causal)
// 2.7e11 and 2.1e11, 0.28 and 0.21 ms at 989 TFLOP/s bf16, against 169 MB
// of inputs and outputs for each (0.05 ms at 3.35 TB/s).  So the design is
// FlashAttention-3's backward products on the pieces of flash_fwd.cu
// (hopper.cuh), but kept as two kernels, as the TPU design has, with no
// atomics: every output element is summed by one thread in a fixed order,
// so the result does not depend on the order in which blocks run, and
// FlashAttention-3's atomic dQ and its third pass are not needed.  Each
// kernel's CTA is three warpgroups: a producer (setmaxnreg.dec to 24
// registers) whose elected thread issues every TMA load into a ring of
// kStages stages, each with a "full" and an "empty" mbarrier, and two
// consumers (setmaxnreg.inc to 240) of 64 accumulator rows each, which keep
// their output in f32 registers for the whole CTA and write it once.
//   flash_dkv: a CTA owns kDkvBK = 128 keys of one (b, KV head): the
//     producer loads the K and V tiles once, then streams the (Q, dO) tiles
//     of kDkvBQ = 64 rows of every visible query tile of every query head
//     of the group; a second producer warp puts those rows' LSE and delta
//     into the same stage (rows past Sq get LSE = +inf, delta = 0).  Per
//     tile, each consumer warpgroup, for its 64 keys:
//       S^T = K Q^T and dP^T = V dO^T: wgmma m64n64k16, both operands read
//         from shared memory K-major (as Q K^T in the forward), D / 16
//         k-steps each; LSE and delta are per query, so per accumulator
//         column;
//       P^T = exp(S^T * scale - LSE), dS^T = P^T o (dP^T - delta), both
//         rounded to bf16 in place into A-operand register fragments;
//       dV += P^T dO and dK += dS^T Q: wgmma m64nDk16 with A from registers
//         and B = dO or Q read MN-major through the descriptor's transpose
//         bit (as P V in the forward), 4 k-steps of 16 queries.
//     dK and dV take 2 x D / 2 f32 registers a thread, S^T and dP^T 2 x 32:
//     192 of the 240 at D = 128.  dK is scaled once at the end.
//   flash_dq: a CTA owns kDqBQ = 128 query rows of one (b, query head): the
//     producer loads the Q and dO tiles once, then streams the K and V tiles
//     of kDqBK = 64 keys it can see.  Per tile, each consumer warpgroup, for
//     its 64 rows: S = Q K^T and dP = dO V^T (m64n64k16, K-major), P and dS
//     (LSE and delta per row, two a thread, read once), dQ += dS K (A = dS
//     from registers, B = K MN-major through the transpose bit).
// Both kernels take the blocks with the most visible tiles first under
// causal masking (dkv's key blocks run forwards, dq's query blocks
// backwards, on the grid's slowest axis).  Keys past Skv read zeros (TMA);
// flash_dq gives them S = -inf, so P = dS = 0, and flash_dkv does not write
// their rows of dK and dV.  Query rows past Sq read zeros and P = 0.
//
// Numerics follow the Pallas kernels: scores scaled in f32; masked pairs set
// to NEG_INF = -1e30 by a select; P = exp(S - LSE) in f32; blocks that no
// pair can see are skipped whole (dkv at 64 queries x 128 keys, dq at 128
// queries x 64 keys, the tiles the plain versions walk); only tiles on the
// diagonal, the window's edge or the ragged end are masked.  One difference:
// P and dS are rounded to bf16 before their tensor-core products, as
// flash_fwd.cu rounds P; the Pallas bodies and the plain versions keep them
// in f32.  exp is the special-function unit's 2^x; on a tile without masked
// pairs one multiply-add forms its argument.  The rules of hopper.cuh that
// keep ptxas from serializing the wgmmas (C7518) hold: each tile's products
// are issued unconditionally inside the tile loop, and no division is made.
#include <math.h>

#include "../../csrc/hopper.cuh"

namespace flash_bwd {

using namespace hopper;

constexpr int kThreads = 384;  // the producer warpgroup, then two consumers
constexpr int kConsumerWarps = 8;
// Registers a thread after setmaxnreg: 128 x 24 + 256 x 240 is the 64 K of
// the SM, which the launch's 384 x 168 hold.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kDkvBK = 128;  // keys of a flash_dkv CTA: 64 for each consumer warpgroup
constexpr int kDkvBQ = 64;   // query rows of its tiles
constexpr int kDkvStages = 4;
constexpr int kDqBQ = 128;   // query rows of a flash_dq CTA: 64 for each consumer warpgroup
constexpr int kDqBK = 64;    // keys of its tiles
constexpr int kDqStages = 4;

// Shared memory of flash_dkv: K and V, then the ring of Q, dO and the rows'
// LSE and delta, then the barriers (K/V, full, empty).
template <int D>
struct DkvSmem {
  using KV = Tile<D, kDkvBK>;
  using Q = Tile<D, kDkvBQ>;
  static constexpr int kK = 0;  // offsets in the 1024-aligned base
  static constexpr int kV = kK + KV::kBytes;
  static constexpr int kQ = kV + KV::kBytes;  // stage st at + st * Q::kBytes
  static constexpr int kDo = kQ + kDkvStages * Q::kBytes;
  static constexpr int kRows = kDo + kDkvStages * Q::kBytes;  // stage st: 64 LSE, 64 delta
  static constexpr int kBars = kRows + kDkvStages * 2 * kDkvBQ * 4;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kDkvStages) + 1024;  // + alignment slack
};

// Shared memory of flash_dq: Q and dO, then the ring of K and V, then the
// barriers (Q/dO, full, empty).
template <int D>
struct DqSmem {
  using Q = Tile<D, kDqBQ>;
  using KV = Tile<D, kDqBK>;
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + Q::kBytes;
  static constexpr int kK = kDo + Q::kBytes;  // stage st at + st * KV::kBytes
  static constexpr int kV = kK + kDqStages * KV::kBytes;
  static constexpr int kBars = kV + kDqStages * KV::kBytes;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kDqStages) + 1024;
};

// Whether any (query, key) pair of queries [q0, q_last] and keys [k0,
// k_last] is visible: the Pallas kernels' block-level skip.
__device__ __forceinline__ bool block_visible(int q0, int q_last, int k0, int k_last, int causal,
                                              int has_window, int window) {
  if (causal && k0 > q_last) return false;
  if (has_window && k_last <= q0 - window) return false;
  return true;
}

// Whether some pair of queries [q0, q_last] and keys [k0, k_last] is hidden
// (the block holds the diagonal or the window's edge).
__device__ __forceinline__ bool block_masked(int q0, int q_last, int k0, int k_last, int causal,
                                             int has_window, int window) {
  return (causal && k_last > q0) || (has_window && k0 <= q_last - window);
}

// Issue (and commit) the two score products of one warpgroup: S = A0 B0^T
// and dP = A1 B1^T, 64 x 64 each, over D; A rows at a0 / a1 in panels of
// APanel bytes, B rows at b0 / b1 in panels of BPanel bytes, all K-major.
template <int D, int APanel, int BPanel>
__device__ __forceinline__ void issue_scores(float (&s)[32], float (&dp)[32], uint32_t a0,
                                             uint32_t b0, uint32_t a1, uint32_t b1) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(s, desc_kmajor<APanel>(a0, kk), desc_kmajor<BPanel>(b0, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(dp, desc_kmajor<APanel>(a1, kk), desc_kmajor<BPanel>(b1, kk), kk > 0);
  wgmma_commit();
}

// P^T and dS^T of one flash_dkv tile in place, for a thread's keys j0 and
// j1 (accumulator rows) and its 16 queries (columns q0 + 8 i + col + {0,
// 1}), whose LSE and delta are lse[c], delta[c] at column c of the tile.
// st becomes P^T, dpt becomes dS^T, both in f32.
template <bool kMasked>
__device__ __forceinline__ void dkv_tile(float (&st)[32], float (&dpt)[32], const float* lse,
                                         const float* delta, int j0, int q0, int col,
                                         float scale, int causal, int has_window, int window) {
  const float k2 = scale * kLog2e;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 l = *reinterpret_cast<const float2*>(lse + 8 * i + col);
    const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * i + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lse_c = (e & 1) ? l.y : l.x;
      const float delta_c = (e & 1) ? dl.y : dl.x;
      float p;
      if constexpr (kMasked) {  // exact: NEG_INF - NEG_INF is 0
        const int key = j0 + (e < 2 ? 0 : 8);
        const int qi = q0 + 8 * i + col + (e & 1);
        const bool hidden = (causal && key > qi) || (has_window && key <= qi - window);
        const float x = hidden ? kNegInf : st[4 * i + e] * scale;
        p = exp2_approx((x - lse_c) * kLog2e);
      } else {
        p = exp2_approx(fmaf(st[4 * i + e], k2, -lse_c * kLog2e));
      }
      st[4 * i + e] = p;
      dpt[4 * i + e] = p * (dpt[4 * i + e] - delta_c);
    }
  }
}

// P and dS of one flash_dq tile in place, for a thread's rows r0 and r1
// (LSE and delta of each) and its 16 keys (columns k0 + 8 i + col + {0,
// 1}); keys past Skv get S = -inf.  s becomes P, dp becomes dS.
template <bool kMasked>
__device__ __forceinline__ void dq_tile(float (&s)[32], float (&dp)[32], int r0, int k0, int col,
                                        int skv, float lse0, float lse1, float delta0,
                                        float delta1, float scale, int causal, int has_window,
                                        int window) {
  const float k2 = scale * kLog2e, b0 = lse0 * kLog2e, b1 = lse1 * kLog2e;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p;
      if constexpr (kMasked) {
        const int row = r0 + (e < 2 ? 0 : 8);
        const int key = k0 + 8 * i + col + (e & 1);
        const bool hidden = (causal && key > row) || (has_window && key <= row - window);
        const float x = key >= skv ? -INFINITY : hidden ? kNegInf : s[4 * i + e] * scale;
        p = exp2_approx((x - (e < 2 ? lse0 : lse1)) * kLog2e);
      } else {
        p = exp2_approx(fmaf(s[4 * i + e], k2, -(e < 2 ? b0 : b1)));
      }
      s[4 * i + e] = p;
      dp[4 * i + e] = p * (dp[4 * i + e] - (e < 2 ? delta0 : delta1));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_dkv_kernel(
    const __grid_constant__ CUtensorMap tm_q,   // (D, Sq, B*Hq), boxes of 64 rows
    const __grid_constant__ CUtensorMap tm_k,   // (D, Skv, B*Hkv), boxes of 128 rows
    const __grid_constant__ CUtensorMap tm_v,   // (D, Skv, B*Hkv), boxes of 128 rows
    const __grid_constant__ CUtensorMap tm_do,  // (D, Sq, B*Hq), boxes of 64 rows
    const float* __restrict__ lse,              // (B, Hq, Sq)
    const float* __restrict__ delta,            // (B, Hq, Sq)
    float* __restrict__ dk,                     // (B, Hkv, Skv, D)
    float* __restrict__ dv,                     // (B, Hkv, Skv, D)
    int hq, int hkv, int sq, int skv, float scale, int causal, int has_window, int window) {
  using M = DkvSmem<D>;
  constexpr int kQPanel = M::Q::kPanelBytes;
  constexpr int kKPanel = M::KV::kPanelBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle's alignment
  float* rows = reinterpret_cast<float*>(smem_raw + (base - raw) + M::kRows);
  const uint32_t bar_kv = base + M::kBars;
  const uint32_t bar_full = bar_kv + 8;                  // stage st at + 8 st
  const uint32_t bar_empty = bar_full + 8 * kDkvStages;  // stage st at + 8 st

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kDkvBK;  // the causal blocks with the most query tiles first
  const int k_last = min(k0 + kDkvBK, skv) - 1;
  const int group = hq / hkv;
  // The query tiles that some pair of the CTA's keys can see: a run (causal
  // cuts its start, the window its end), the same for every head.
  const int n_qt = (sq + kDkvBQ - 1) / kDkvBQ;
  int qt_begin = 0, qt_end = n_qt;
  while (qt_begin < qt_end &&
         !block_visible(qt_begin * kDkvBQ, min(qt_begin * kDkvBQ + kDkvBQ, sq) - 1, k0, k_last,
                        causal, has_window, window))
    ++qt_begin;
  while (qt_end > qt_begin &&
         !block_visible((qt_end - 1) * kDkvBQ, min(qt_end * kDkvBQ, sq) - 1, k0, k_last, causal,
                        has_window, window))
    --qt_end;
  const int n_tiles = group * (qt_end - qt_begin);  // each head's visible query tiles in turn

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < kDkvStages; ++st) {
      mbar_init(bar_full + 8 * st, 1 + 32);  // the TMA thread and the 32 lanes of the rows
      mbar_init(bar_empty + 8 * st, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // The warpgroup index, warp-uniform in the compiler's eyes.
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    // ---- producer: one thread issues every load, warp 1 copies the rows ----
    // (24 registers a thread: the tile walks keep counters, not divisions,
    // and are not unrolled, or warp 1 spills)
    setmaxnreg_dec<kProducerRegs>();
    const int head_q0 = b * hq + kvh * group;  // the group's first query head
    if (threadIdx.x == 0) {
      const int head_kv = b * hkv + kvh;
      mbar_expect_tx(bar_kv, 2 * M::KV::kBytes);
      tma_load_tile<D, kDkvBK>(base + M::kK, &tm_k, bar_kv, k0, head_kv);
      tma_load_tile<D, kDkvBK>(base + M::kV, &tm_v, bar_kv, k0, head_kv);
      int st = 0, phase = 0, hh = 0, qt = qt_begin;
#pragma unroll 1
      for (int j = 0; j < n_tiles; ++j) {
        mbar_wait(bar_empty + 8 * st, phase ^ 1);  // round 0 passes at once
        const uint32_t full = bar_full + 8 * st;
        mbar_expect_tx(full, 2 * M::Q::kBytes);
        tma_load_tile<D, kDkvBQ>(base + M::kQ + st * M::Q::kBytes, &tm_q, full, qt * kDkvBQ,
                                 head_q0 + hh);
        tma_load_tile<D, kDkvBQ>(base + M::kDo + st * M::Q::kBytes, &tm_do, full, qt * kDkvBQ,
                                 head_q0 + hh);
        if (++qt == qt_end) qt = qt_begin, ++hh;
        if (++st == kDkvStages) st = 0, phase ^= 1;
      }
    } else if (threadIdx.x / 32 == 1) {
      const int lane = threadIdx.x % 32;
      const float* l = lse + (size_t)head_q0 * sq;  // the current head's rows
      const float* dl = delta + (size_t)head_q0 * sq;
      int st = 0, phase = 0, qt = qt_begin;
#pragma unroll 1
      for (int j = 0; j < n_tiles; ++j) {
        mbar_wait(bar_empty + 8 * st, phase ^ 1);
        float* r = rows + st * 2 * kDkvBQ;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = qt * kDkvBQ + lane + 32 * h;
          r[lane + 32 * h] = i < sq ? l[i] : INFINITY;
          r[kDkvBQ + lane + 32 * h] = i < sq ? dl[i] : 0.f;
        }
        mbar_arrive(bar_full + 8 * st);
        if (++qt == qt_end) qt = qt_begin, l += sq, dl += sq;
        if (++st == kDkvStages) st = 0, phase ^= 1;
      }
    }
  } else {
    // ---- consumers: 64 keys each ----
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = role - 1;  // consumer 0 or 1
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int wk0 = k0 + cw * 64;  // the warpgroup's first key
    const int j0 = wk0 + warp * 16 + lane / 4;  // this thread's two keys
    const int j1 = j0 + 8;
    const int col = 2 * (lane % 4);  // its first column in each 8-column block
    const uint32_t k_rows = base + M::kK + cw * 64 * 128;  // its 64 rows in each K panel
    const uint32_t v_rows = base + M::kV + cw * 64 * 128;

    float dk_acc[D / 2], dv_acc[D / 2];  // D / 8 blocks of 8 columns, 4 values a thread each
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    float st[32], dpt[32];       // S^T then P^T, dP^T then dS^T: 8 blocks of 8 queries
    uint32_t pa[4][4], dsa[4][4];  // P^T and dS^T in bf16: A fragments of 16 queries

    mbar_wait(bar_kv, 0);
    int stg = 0, phase = 0, qt = qt_begin;
    for (int j = 0; j < n_tiles; ++j) {
      const int q0 = qt * kDkvBQ;
      const uint32_t q_tile = base + M::kQ + stg * M::Q::kBytes;
      const uint32_t do_tile = base + M::kDo + stg * M::Q::kBytes;
      mbar_wait(bar_full + 8 * stg, phase);
      issue_scores<D, kKPanel, kQPanel>(st, dpt, k_rows, q_tile, v_rows, do_tile);
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);
      const float* r = rows + stg * 2 * kDkvBQ;
      if (block_masked(q0, q0 + kDkvBQ - 1, wk0, wk0 + 63, causal, has_window, window)) {
        dkv_tile<true>(st, dpt, r, r + kDkvBQ, j0, q0, col, scale, causal, has_window, window);
      } else {
        dkv_tile<false>(st, dpt, r, r + kDkvBQ, j0, q0, col, scale, causal, has_window, window);
      }
      pack_a(pa, st);
      pack_a(dsa, dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDkvBQ / 16; ++kk)
        wgmma_rs<D>(dv_acc, pa[kk], desc_mnmajor<kQPanel>(do_tile, kk));
#pragma unroll
      for (int kk = 0; kk < kDkvBQ / 16; ++kk)
        wgmma_rs<D>(dk_acc, dsa[kk], desc_mnmajor<kQPanel>(q_tile, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pa);
      fence_regs(dsa);
      if (lane == 0) mbar_arrive(bar_empty + 8 * stg);  // this warp is done with the stage
      if (++qt == qt_end) qt = qt_begin;
      if (++stg == kDkvStages) stg = 0, phase ^= 1;
    }

    const size_t bh = (size_t)b * hkv + kvh;
    float* dkb = dk + bh * skv * D;
    float* dvb = dv + bh * skv * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int c = 8 * i + col;
      if (j0 < skv) {
        *reinterpret_cast<float2*>(dkb + (size_t)j0 * D + c) =
            make_float2(dk_acc[4 * i] * scale, dk_acc[4 * i + 1] * scale);
        *reinterpret_cast<float2*>(dvb + (size_t)j0 * D + c) =
            make_float2(dv_acc[4 * i], dv_acc[4 * i + 1]);
      }
      if (j1 < skv) {
        *reinterpret_cast<float2*>(dkb + (size_t)j1 * D + c) =
            make_float2(dk_acc[4 * i + 2] * scale, dk_acc[4 * i + 3] * scale);
        *reinterpret_cast<float2*>(dvb + (size_t)j1 * D + c) =
            make_float2(dv_acc[4 * i + 2], dv_acc[4 * i + 3]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_dq_kernel(
    const __grid_constant__ CUtensorMap tm_q,   // (D, Sq, B*Hq), boxes of 128 rows
    const __grid_constant__ CUtensorMap tm_k,   // (D, Skv, B*Hkv), boxes of 64 rows
    const __grid_constant__ CUtensorMap tm_v,   // (D, Skv, B*Hkv), boxes of 64 rows
    const __grid_constant__ CUtensorMap tm_do,  // (D, Sq, B*Hq), boxes of 128 rows
    const float* __restrict__ lse,              // (B, Hq, Sq)
    const float* __restrict__ delta,            // (B, Hq, Sq)
    float* __restrict__ dq,                     // (B, Hq, Sq, D)
    int hq, int hkv, int sq, int skv, float scale, int causal, int has_window, int window) {
  using M = DqSmem<D>;
  constexpr int kQPanel = M::Q::kPanelBytes;
  constexpr int kKPanel = M::KV::kPanelBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's alignment
  const uint32_t bar_q = base + M::kBars;
  const uint32_t bar_full = bar_q + 8;                  // stage st at + 8 st
  const uint32_t bar_empty = bar_full + 8 * kDqStages;  // stage st at + 8 st

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kDqBQ;  // the longest causal rows first
  const int q_last = min(q0 + kDqBQ, sq) - 1;
  // The key tiles that some pair of the CTA's rows can see: a run (causal
  // cuts its end, the window its start).
  const int n_kt = (skv + kDqBK - 1) / kDqBK;
  int kt_begin = 0, kt_end = n_kt;
  while (kt_end > kt_begin &&
         !block_visible(q0, q_last, (kt_end - 1) * kDqBK, min(kt_end * kDqBK, skv) - 1, causal,
                        has_window, window))
    --kt_end;
  while (kt_begin < kt_end &&
         !block_visible(q0, q_last, kt_begin * kDqBK, min(kt_begin * kDqBK + kDqBK, skv) - 1,
                        causal, has_window, window))
    ++kt_begin;
  const int n_tiles = kt_end - kt_begin;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kDqStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    // ---- producer: one thread issues every load ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      const int head_q = b * hq + h;
      const int head_kv = b * hkv + h / (hq / hkv);
      mbar_expect_tx(bar_q, 2 * M::Q::kBytes);
      tma_load_tile<D, kDqBQ>(base + M::kQ, &tm_q, bar_q, q0, head_q);
      tma_load_tile<D, kDqBQ>(base + M::kDo, &tm_do, bar_q, q0, head_q);
#pragma unroll 1
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kDqStages;
        const int k0 = (kt_begin + j) * kDqBK;
        mbar_wait(bar_empty + 8 * st, ((j / kDqStages) & 1) ^ 1);  // round 0 passes at once
        const uint32_t full = bar_full + 8 * st;
        mbar_expect_tx(full, 2 * M::KV::kBytes);
        tma_load_tile<D, kDqBK>(base + M::kK + st * M::KV::kBytes, &tm_k, full, k0, head_kv);
        tma_load_tile<D, kDqBK>(base + M::kV + st * M::KV::kBytes, &tm_v, full, k0, head_kv);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = role - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int wq0 = q0 + cw * 64;  // the warpgroup's first row
    const int r0 = wq0 + warp * 16 + lane / 4;  // this thread's two query rows
    const int r1 = r0 + 8;
    const int col = 2 * (lane % 4);
    const size_t row0 = ((size_t)b * hq + h) * sq;
    const float lse0 = r0 < sq ? lse[row0 + r0] : INFINITY;
    const float lse1 = r1 < sq ? lse[row0 + r1] : INFINITY;
    const float delta0 = r0 < sq ? delta[row0 + r0] : 0.f;
    const float delta1 = r1 < sq ? delta[row0 + r1] : 0.f;
    const uint32_t q_rows = base + M::kQ + cw * 64 * 128;  // its 64 rows in each Q panel
    const uint32_t do_rows = base + M::kDo + cw * 64 * 128;

    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
    float s[32], dp[32];  // S then P, dP then dS: 8 blocks of 8 keys
    uint32_t dsa[4][4];   // dS in bf16: A fragments of 16 keys

    mbar_wait(bar_q, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int stg = j % kDqStages;
      const int k0 = (kt_begin + j) * kDqBK;
      const uint32_t k_tile = base + M::kK + stg * M::KV::kBytes;
      const uint32_t v_tile = base + M::kV + stg * M::KV::kBytes;
      mbar_wait(bar_full + 8 * stg, (j / kDqStages) & 1);
      issue_scores<D, kQPanel, kKPanel>(s, dp, q_rows, k_tile, do_rows, v_tile);
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);
      if (k0 + kDqBK > skv ||
          block_masked(wq0, wq0 + 63, k0, k0 + kDqBK - 1, causal, has_window, window)) {
        dq_tile<true>(s, dp, r0, k0, col, skv, lse0, lse1, delta0, delta1, scale, causal,
                      has_window, window);
      } else {
        dq_tile<false>(s, dp, r0, k0, col, skv, lse0, lse1, delta0, delta1, scale, causal,
                       has_window, window);
      }
      pack_a(dsa, dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDqBK / 16; ++kk)
        wgmma_rs<D>(dq_acc, dsa[kk], desc_mnmajor<kKPanel>(k_tile, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq_acc);
      fence_regs(dsa);
      if (lane == 0) mbar_arrive(bar_empty + 8 * stg);  // this warp is done with the stage
    }

    float* dqb = dq + row0 * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int c = 8 * i + col;
      if (r0 < sq)
        *reinterpret_cast<float2*>(dqb + (size_t)r0 * D + c) =
            make_float2(dq_acc[4 * i] * scale, dq_acc[4 * i + 1] * scale);
      if (r1 < sq)
        *reinterpret_cast<float2*>(dqb + (size_t)r1 * D + c) =
            make_float2(dq_acc[4 * i + 2] * scale, dq_acc[4 * i + 3] * scale);
    }
  }
}

// The four tensor maps of a backward kernel: q and dO in boxes of q_rows,
// k and v in boxes of k_rows.
static bool make_maps(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v,
                      const void* dout, int d, int batch, int hq, int hkv, int sq, int skv,
                      int q_rows, int k_rows) {
  return make_map(&maps[0], q, d, sq, batch * hq, q_rows) &&
         make_map(&maps[1], k, d, skv, batch * hkv, k_rows) &&
         make_map(&maps[2], v, d, skv, batch * hkv, k_rows) &&
         make_map(&maps[3], dout, d, sq, batch * hq, q_rows);
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, float* dk, float* dv, int batch, int hq, int hkv, int sq,
               int skv, float scale, int causal, int has_window, int window,
               cudaStream_t stream) {
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap maps[4];
  if (!make_maps(maps, q, k, v, dout, D, batch, hq, hkv, sq, skv, kDkvBQ, kDkvBK))
    return (int)cudaErrorInvalidValue;
  constexpr int kSmem = DkvSmem<D>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(hkv, batch, (skv + kDkvBK - 1) / kDkvBK);
  flash_dkv_kernel<D><<<grid, kThreads, kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta, dk, dv, hq, hkv, sq, skv, scale, causal,
      has_window, window);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, float* dq, int batch, int hq, int hkv, int sq, int skv,
              float scale, int causal, int has_window, int window, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap maps[4];
  if (!make_maps(maps, q, k, v, dout, D, batch, hq, hkv, sq, skv, kDqBQ, kDqBK))
    return (int)cudaErrorInvalidValue;
  constexpr int kSmem = DqSmem<D>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(hq, batch, (sq + kDqBQ - 1) / kDqBQ);
  flash_dq_kernel<D><<<grid, kThreads, kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta, dq, hq, hkv, sq, skv, scale, causal,
      has_window, window);
  return (int)cudaGetLastError();
}

}  // namespace flash_bwd

// dK, dV of attention for bf16 (B, H, S, D) q, k, v, dO with D in {16, 32, 64, 112, 128},
// 16-byte aligned, and f32 LSE and delta (B, Hq, Sq); writes f32 dK, dV
// (B, Hkv, Skv, D).  Returns a cudaError_t as int (cudaErrorInvalidValue for
// any other D or a tensor map that does not encode, cudaErrorNotSupported
// without cuTensorMapEncodeTiled).  No synchronisation.
extern "C" int flash_dkv_launch(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, float* dk, float* dv,
                                int batch, int hq, int hkv, int sq, int skv, int d, float scale,
                                int causal, int has_window, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_DKV_CASE(D)                                                                  \
  case D:                                                                                  \
    return flash_bwd::launch_dkv<D>(q, k, v, dout, lse, delta, dk, dv, batch, hq, hkv, sq, \
                                    skv, scale, causal, has_window, window, st);
  switch (d) {
    FLASH_DKV_CASE(128)
    FLASH_DKV_CASE(112)
    FLASH_DKV_CASE(64)
    FLASH_DKV_CASE(32)
    FLASH_DKV_CASE(16)
  }
#undef FLASH_DKV_CASE
  return (int)cudaErrorInvalidValue;
}

// dQ of attention for the same inputs; writes f32 dQ (B, Hq, Sq, D).
extern "C" int flash_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* delta, float* dq, int batch,
                               int hq, int hkv, int sq, int skv, int d, float scale, int causal,
                               int has_window, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_DQ_CASE(D)                                                                    \
  case D:                                                                                   \
    return flash_bwd::launch_dq<D>(q, k, v, dout, lse, delta, dq, batch, hq, hkv, sq, skv,  \
                                   scale, causal, has_window, window, st);
  switch (d) {
    FLASH_DQ_CASE(128)
    FLASH_DQ_CASE(112)
    FLASH_DQ_CASE(64)
    FLASH_DQ_CASE(32)
    FLASH_DQ_CASE(16)
  }
#undef FLASH_DQ_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
