// FlashAttention forward for Hopper (sm_90a): TMA, an mbarrier ring and wgmma.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:163
// (flash_fwd, _fwd_kernel) -> flash_fwd_launch.  Layout (B, H, S, D),
// row-major, D in {16, 32, 64, 112, 128}.  Outputs O (B, Hq, Sq, D) in bf16 and the
// log-sum-exp (B, Hq, Sq) in f32.  GQA: query head h reads KV head
// h / (Hq / Hkv), so K and V are never repeated per query head.
//
// What bounds it: operations, 4 D a visible (query, key) pair (2 D in each
// of Q K^T and P V) over the 989 TFLOP/s of the bf16 tensor cores.  At the
// serving shape (B=4, Hq=32, Hkv=8, S=2048, D=128, causal) that is 1.4e11
// operations, 0.139 ms, against 168 MB of inputs and outputs, 0.05 ms at
// 3.35 TB/s.  Only wgmma reaches the tensor cores' full rate, and it needs
// its operands in shared memory in the layout TMA writes, so the design is
// FlashAttention-3's forward, without its ping-pong between the consumer
// warpgroups:
//   * a CTA of three warpgroups owns kBQ = 128 query rows of one (b, h);
//     one producer warpgroup (setmaxnreg.dec to 24 registers) whose elected
//     thread issues every TMA load: the Q tile once, then the K and V tiles
//     of kBK = 128 keys into a ring of kStages = 3 stages, each with a
//     "full" mbarrier (the load's bytes landed) and an "empty" one (the 8
//     consumer warps are done with it);
//   * two consumer warpgroups (setmaxnreg.inc to 240 registers), 64 query
//     rows each: S = Q K^T is wgmma m64n128k16 with A = Q and B = K both
//     read from shared memory, both K-major (so K needs no transposed copy);
//     the online softmax runs on the f32 accumulator in registers; P is
//     rounded to bf16 in place into the A-operand register fragments, and
//     O += P V is wgmma m64nDk16 with A from registers and B = V read from
//     shared memory MN-major (the descriptor's transpose bit), so V needs no
//     transposed copy either.  O stays in registers for the whole CTA.
//     Each warpgroup issues tile t's Q K^T together with tile t - 1's P V
//     and runs tile t's softmax while P V is on the tensor cores
//     (FlashAttention-3's intra-warpgroup overlap), so a tile's K and V
//     stay in their stage until the next tile's softmax is done: hence
//     three stages, so that the next load never waits for that release.
// Tiles are 64-column panels of 128-byte rows in the 128-byte swizzle that
// TMA writes and wgmma reads (32 KB a Q, K or V tile at D = 128; Q plus
// three K/V stages is 224 KB of the 227 KB).  At D = 112 the tensor maps' inner
// extent is 112 and the second panel's boxes reach column 127, so TMA fills
// columns 112-127 with zeros: Q K^T takes 7 k-steps and P V has N = 112.
// D = 16 and D = 32 are one panel by the same rule (TMA fills columns D-63
// with zeros): Q K^T takes 1 or 2 k-steps and P V has N = 16 or 32.
// The two warpgroups' softmax and products interleave on the SM's tensor
// cores; a CTA takes the causal query blocks with the most key tiles first
// (the query-block index runs backwards, on the grid's slowest axis).
//
// Numerics follow the Pallas kernel: scores scaled in f32; masked pairs set
// to NEG_INF = -1e30 (finite, so (-inf) - (-inf) never occurs); key tiles
// that no query row of the CTA can see are skipped whole (the reference's
// block-level pl.when) and only tiles on the diagonal, the window's edge or
// the ragged end are masked; P is rounded to bf16 before the P V product;
// O = acc / max(l, 1e-30) and LSE = m + log(max(l, 1e-30)).  Keys past Skv
// (TMA fills them with zeros) get -inf, so they add exactly 0.  Query rows
// past Sq are computed on zeros and not written.  Two cheaper routes to
// the same values: exp is the special-function unit's 2^x (and on a tile
// without masked pairs one multiply-add forms its argument), and the final
// division is a reciprocal and one Newton step.
//
// The Hopper pieces (the mbarrier ring, TMA, wgmma descriptors and
// products, setmaxnreg, the tensor maps) are in hopper.cuh, shared with
// flash_bwd.cu; so are the rules that keep ptxas from serializing the
// wgmmas (info C7518).  Here they mean: the consumers' loop peels its first
// tile instead of testing for it, and the epilogue divides by a reciprocal
// and one Newton step.
#include <math.h>

#include "../../csrc/hopper.cuh"

namespace flash {

using namespace hopper;

constexpr int kBQ = 128;          // query rows a CTA: 64 for each consumer warpgroup
constexpr int kBK = 128;          // keys a tile
constexpr int kStages = 3;        // K/V stages of the ring
constexpr int kThreads = 384;     // the producer warpgroup, then two consumers
constexpr int kPanelBytes = 128 * 128;  // a panel of 128 rows
constexpr int kConsumerWarps = 8;
// Registers a thread after setmaxnreg: 128 x 24 + 256 x 240 is the 64 K of
// the SM, which the launch's 384 x 168 hold.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tiles {
  static constexpr int kPanels = (D + kPanelCols - 1) / kPanelCols;  // 1 or 2
  static constexpr int kSteps = D / 16;           // k-steps of Q K^T: 1, 2, 4, 7 or 8
  static constexpr int kBytes = kPanels * kPanelBytes;  // a Q, K or V tile
  static constexpr int kQ = 0;                    // offsets in the 1024-aligned base
  static constexpr int kK = kBytes;
  static constexpr int kV = kK + kStages * kBytes;
  static constexpr int kBars = kV + kStages * kBytes;
  static constexpr int kSmem = kBars + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
};

// a / d from r = 1 / d and one Newton step: the correctly rounded quotient
// (as a / d) for the normal operands here, without the division's slow
// path, whose branch would make ptxas serialize every wgmma.
__device__ __forceinline__ float quotient(float a, float d, float r) {
  const float q = a * r;
  return fmaf(fmaf(-q, d, a), r, q);
}

// Whether any (query, key) pair of the CTA's rows [q0, q_last] and the key
// tile at k0 is visible: the Pallas kernel's block-level skip.
__device__ __forceinline__ bool tile_visible(int k0, int skv, int q0, int q_last, int causal,
                                             int has_window, int window) {
  const int k_last = min(k0 + kBK, skv) - 1;
  if (causal && k0 > q_last) return false;
  if (has_window && k_last <= q0 - window) return false;
  return true;
}

// What a consumer thread needs to mask and scale its rows of a tile.
struct Rows {
  int r0, r1, col, skv, causal, has_window, window;
  float scale;
};

// One tile's online softmax on S (64 per thread, rows r0 and r1) in place:
// s becomes P = exp(S * scale - m) in f32, m and l move on, and alpha is
// the factor that takes O from the old m to the new one.  On a masked tile
// the scores are scaled, masked and exponentiated exactly as the plain
// version does; on a tile without masked pairs the scores are all finite,
// so max(S) * scale (rounding is monotone, so equal to the plain version's
// max) and exp2 of one fused multiply-add per score suffice.
template <bool kMasked>
__device__ __forceinline__ void softmax_tile(float (&s)[64], const Rows& w, int k0, float& m0,
                                             float& m1, float& l0, float& l1, float& alpha0,
                                             float& alpha1) {
  float mx0 = kMasked ? m0 : -INFINITY, mx1 = kMasked ? m1 : -INFINITY;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if constexpr (kMasked) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? w.r0 : w.r1;
        const int key = k0 + 8 * i + w.col + (e & 1);
        const bool hidden = (w.causal && key > row) || (w.has_window && key <= row - w.window);
        const float x = hidden ? kNegInf : s[4 * i + e] * w.scale;
        s[4 * i + e] = key >= w.skv ? -INFINITY : x;
      }
    }
    mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  if constexpr (!kMasked) {
    mx0 = fmaxf(m0, mx0 * w.scale);
    mx1 = fmaxf(m1, mx1 * w.scale);
  }
  alpha0 = exp2_approx((m0 - mx0) * kLog2e);
  alpha1 = exp2_approx((m1 - mx1) * kLog2e);
  float sum0 = 0.f, sum1 = 0.f;
  const float k2 = w.scale * kLog2e, b0 = mx0 * kLog2e, b1 = mx1 * kLog2e;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if constexpr (kMasked) {  // exact: NEG_INF - NEG_INF is 0
      s[4 * i] = exp2_approx((s[4 * i] - mx0) * kLog2e);
      s[4 * i + 1] = exp2_approx((s[4 * i + 1] - mx0) * kLog2e);
      s[4 * i + 2] = exp2_approx((s[4 * i + 2] - mx1) * kLog2e);
      s[4 * i + 3] = exp2_approx((s[4 * i + 3] - mx1) * kLog2e);
    } else {
      s[4 * i] = exp2_approx(fmaf(s[4 * i], k2, -b0));
      s[4 * i + 1] = exp2_approx(fmaf(s[4 * i + 1], k2, -b0));
      s[4 * i + 2] = exp2_approx(fmaf(s[4 * i + 2], k2, -b1));
      s[4 * i + 3] = exp2_approx(fmaf(s[4 * i + 3], k2, -b1));
    }
    sum0 += s[4 * i] + s[4 * i + 1];
    sum1 += s[4 * i + 2] + s[4 * i + 3];
  }
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
  l0 = l0 * alpha0 + sum0;
  l1 = l1 * alpha1 + sum1;
  m0 = mx0;
  m1 = mx1;
}

// Issue (and commit) O += P V over the 128 keys of the V tile at v_tile:
// 16 of V's rows a k-step (16 x 128 bytes), its two panels 16 KB apart along
// N (D), read MN-major.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], const uint32_t (&pa)[8][4],
                                         uint32_t v_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_rs<D>(acc, pa[kk], desc_sw128(v_tile + kk * 16 * 128, kPanelBytes, 1024));
  wgmma_commit();
}


// Issue (and commit) S = Q K^T for this warpgroup's 64 rows against the K
// tile at k_tile: k-step kk reads 16 columns of panel kk / 4 (32 bytes along
// the swizzled 128-byte rows; 8-row groups 1024 bytes apart).
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q_rows, uint32_t k_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Tiles<D>::kSteps; ++kk) {
    const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
    wgmma_ss_n128(s, desc_sw128(q_rows + off, 16, 1024), desc_sw128(k_tile + off, 16, 1024),
                  kk > 0);
  }
  wgmma_commit();
}

// The softmax of the tile at k0, masked only where the tile holds the
// diagonal, the window's edge or the ragged end.
__device__ __forceinline__ void softmax_any(float (&s)[64], const Rows& w, int k0, int q0,
                                            int q_last, float& m0, float& m1, float& l0,
                                            float& l1, float& alpha0, float& alpha1) {
  const int k_last = min(k0 + kBK, w.skv) - 1;
  const bool masked = k0 + kBK > w.skv || (w.causal && k_last > q0) ||
                      (w.has_window && k0 <= q_last - w.window);
  if (masked) {
    softmax_tile<true>(s, w, k0, m0, m1, l0, l1, alpha0, alpha1);
  } else {
    softmax_tile<false>(s, w, k0, m0, m1, l0, l1, alpha0, alpha1);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_kernel(
    const __grid_constant__ CUtensorMap tm_q,  // (D, Sq, B*Hq)
    const __grid_constant__ CUtensorMap tm_k,  // (D, Skv, B*Hkv)
    const __grid_constant__ CUtensorMap tm_v,  // (D, Skv, B*Hkv)
    __nv_bfloat16* __restrict__ o,             // (B, Hq, Sq, D)
    float* __restrict__ lse,                   // (B, Hq, Sq)
    int hq, int hkv, int sq, int skv, float scale, int causal, int has_window, int window) {
  using T = Tiles<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's alignment
  const uint32_t s_q = base + T::kQ;
  const uint32_t s_k = base + T::kK;  // stage st at + st * T::kBytes
  const uint32_t s_v = base + T::kV;
  const uint32_t bar_q = base + T::kBars;
  const uint32_t bar_full = bar_q + 8;                // stage st at + 8 st
  const uint32_t bar_empty = bar_full + 8 * kStages;  // stage st at + 8 st

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // the longest causal rows first
  const int q_last = min(q0 + kBQ, sq) - 1;
  const int n_tiles = (skv + kBK - 1) / kBK;
  // The key tiles that some pair of the CTA's rows can see: a run (causal
  // cuts its end, the window its start).
  int kt_begin = 0, kt_end = n_tiles;
  while (kt_end > 0 && !tile_visible((kt_end - 1) * kBK, skv, q0, q_last, causal, has_window,
                                     window))
    --kt_end;
  while (kt_begin < kt_end && !tile_visible(kt_begin * kBK, skv, q0, q_last, causal,
                                            has_window, window))
    ++kt_begin;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // The warpgroup index, warp-uniform in the compiler's eyes.
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    // ---- producer: one thread issues every load ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      const int head_q = b * hq + h;
      const int head_kv = b * hkv + h / (hq / hkv);
      mbar_expect_tx(bar_q, T::kBytes);
      for (int p = 0; p < T::kPanels; ++p)
        tma_load(s_q + p * kPanelBytes, &tm_q, bar_q, p * kPanelCols, q0, head_q);
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * kBK;
        const int j = kt - kt_begin;
        const int st = j % kStages;
        mbar_wait(bar_empty + 8 * st, ((j / kStages) & 1) ^ 1);  // round 0 passes at once
        const uint32_t full = bar_full + 8 * st;
        mbar_expect_tx(full, 2 * T::kBytes);
        for (int p = 0; p < T::kPanels; ++p) {
          tma_load(s_k + st * T::kBytes + p * kPanelBytes, &tm_k, full, p * kPanelCols, k0,
                   head_kv);
          tma_load(s_v + st * T::kBytes + p * kPanelBytes, &tm_v, full, p * kPanelCols, k0,
                   head_kv);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = role - 1;  // consumer 0 or 1
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int r0 = q0 + cw * 64 + warp * 16 + lane / 4;  // this thread's two query rows
    const int r1 = r0 + 8;
    const int col = 2 * (lane % 4);  // its first column in each 8-column block
    const uint32_t q_rows = s_q + cw * 64 * 128;  // its 64 rows in each Q panel

    float acc[D / 2];  // O: D / 8 blocks of 8 columns, 4 values a thread each
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float s[64];       // S, then P in f32: 16 blocks of 8 keys
    uint32_t pa[8][4];  // P in bf16: the A fragments of 16 keys a k-step
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    const Rows rows{r0, r1, col, skv, causal, has_window, window, scale};

    mbar_wait(bar_q, 0);
    // Tile j's Q K^T is issued together with tile j - 1's P V, and tile j's
    // softmax runs while that P V is on the tensor cores; O is rescaled once
    // it is done.
    const int n_vis = kt_end - kt_begin;
    if (n_vis > 0) {
      mbar_wait(bar_full, 0);
      issue_qk<D>(s, q_rows, s_k);
      wgmma_wait_all();
      fence_regs(s);
      float alpha0, alpha1;
      softmax_any(s, rows, kt_begin * kBK, q0, q_last, m0, m1, l0, l1, alpha0, alpha1);
      pack_a(pa, s);  // P rounded to bf16 in place
      for (int j = 1; j < n_vis; ++j) {
        const int st = j % kStages;
        const int prev = (j - 1) % kStages;
        mbar_wait(bar_full + 8 * st, (j / kStages) & 1);
        issue_qk<D>(s, q_rows, s_k + st * T::kBytes);
        issue_pv<D>(acc, pa, s_v + prev * T::kBytes);
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // Q K^T is done
        fence_regs(s);
        softmax_any(s, rows, (kt_begin + j) * kBK, q0, q_last, m0, m1, l0, l1, alpha0, alpha1);
        wgmma_wait_all();
        fence_regs(acc);
        fence_regs(pa);
        if (lane == 0) mbar_arrive(bar_empty + 8 * prev);  // this warp is done with it
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          acc[4 * i] *= alpha0;
          acc[4 * i + 1] *= alpha0;
          acc[4 * i + 2] *= alpha1;
          acc[4 * i + 3] *= alpha1;
        }
        pack_a(pa, s);  // P rounded to bf16 in place
      }
      issue_pv<D>(acc, pa, s_v + ((n_vis - 1) % kStages) * T::kBytes);
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(pa);
    }

    const float d0 = fmaxf(l0, 1e-30f);
    const float d1 = fmaxf(l1, 1e-30f);
    const size_t bh = (size_t)b * hq + h;
    __nv_bfloat16* ob = o + bh * sq * D;
    const float inv0 = 1.f / d0, inv1 = 1.f / d1;
    uint32_t out0[D / 8], out1[D / 8];
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      out0[i] = pack_bf16(quotient(acc[4 * i], d0, inv0), quotient(acc[4 * i + 1], d0, inv0));
      out1[i] = pack_bf16(quotient(acc[4 * i + 2], d1, inv1),
                          quotient(acc[4 * i + 3], d1, inv1));
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      if (r0 < sq) *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * D + 8 * i + col) = out0[i];
      if (r1 < sq) *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * D + 8 * i + col) = out1[i];
    }
    if (lane % 4 == 0) {
      float* lb = lse + bh * sq;
      if (r0 < sq) lb[r0] = m0 + logf(d0);
      if (r1 < sq) lb[r1] = m1 + logf(d1);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
           int hq, int hkv, int sq, int skv, float scale, int causal, int has_window,
           int window, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(&tm_q, q, D, sq, batch * hq, kBQ) ||
      !make_map(&tm_k, k, D, skv, batch * hkv, kBK) ||
      !make_map(&tm_v, v, D, skv, batch * hkv, kBK))
    return (int)cudaErrorInvalidValue;
  constexpr int kSmem = Tiles<D>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(hq, batch, (sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<D><<<grid, kThreads, kSmem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, hq, hkv, sq, skv, scale, causal,
      has_window, window);
  return (int)cudaGetLastError();
}

}  // namespace flash

// O, LSE = attention(Q, K, V) for bf16 (B, H, S, D) tensors with D in
// {16, 32, 64, 112, 128}, 16-byte aligned; returns a cudaError_t as int
// (cudaErrorInvalidValue for any other D or a tensor map that does not
// encode, cudaErrorNotSupported without cuTensorMapEncodeTiled).  No
// synchronisation.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                float* lse, int batch, int hq, int hkv, int sq, int skv,
                                int d, float scale, int causal, int has_window, int window,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_FWD_CASE(D)                                                                  \
  case D:                                                                                  \
    return flash::launch<D>(q, k, v, o, lse, batch, hq, hkv, sq, skv, scale, causal,       \
                            has_window, window, st);
  switch (d) {
    FLASH_FWD_CASE(128)
    FLASH_FWD_CASE(112)
    FLASH_FWD_CASE(64)
    FLASH_FWD_CASE(32)
    FLASH_FWD_CASE(16)
  }
#undef FLASH_FWD_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
