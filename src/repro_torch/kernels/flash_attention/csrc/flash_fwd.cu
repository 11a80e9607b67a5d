// FlashAttention forward for Hopper (sm_90a): TMA, an mbarrier ring and wgmma.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:163
// (flash_fwd, _fwd_kernel) -> flash_fwd_launch.  Layout (B, H, S, D),
// row-major, D in {64, 112, 128}.  Outputs O (B, Hq, Sq, D) in bf16 and the
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
// ptxas serializes every wgmma of a kernel (info C7518) when a wgmma or its
// registers sit on a path it cannot prove warp-uniform, or when other
// instructions may write an accumulator while a product is in flight.  So
// the consumers' loop peels its first tile instead of testing for it, the
// barrier wait keeps its retry loop inside one asm statement, and the
// epilogue has no division with a slow path; the warpgroup index is read
// through a shuffle, as CUTLASS does, so that it is warp-uniform too.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int kBQ = 128;          // query rows a CTA: 64 for each consumer warpgroup
constexpr int kBK = 128;          // keys a tile
constexpr int kStages = 3;        // K/V stages of the ring
constexpr int kThreads = 384;     // the producer warpgroup, then two consumers
constexpr int kPanelCols = 64;    // bf16 columns of a panel: one 128-byte swizzled row
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
  static constexpr int kSteps = D / 16;           // k-steps of Q K^T: 4, 7 or 8
  static constexpr int kBytes = kPanels * kPanelBytes;  // a Q, K or V tile
  static constexpr int kQ = 0;                    // offsets in the 1024-aligned base
  static constexpr int kK = kBytes;
  static constexpr int kV = kK + kStages * kBytes;
  static constexpr int kBars = kV + kStages * kBytes;
  static constexpr int kSmem = kBars + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase of the given parity has completed.  The
// retry loop stays inside the asm: a branch out of it (a time-out that
// traps, say) would put the wait on a divergent path, and ptxas then
// serializes every wgmma of the kernel.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box {64 columns, 128 rows, 1 head} of a 3-d (D, S, B*H) tensor map.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(head)
      : "memory");
}

// A wgmma shared-memory descriptor for the 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
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

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The same for the A fragments of a product with A in registers: the
// hardware reads them until the product is done, so they must stay live
// (and unmoved) until the wait.
__device__ __forceinline__ void fence_regs(uint32_t (&r)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

// 2^x on the special-function unit (relative error 2^-22; results below
// 2^-126 flush to 0, which changes no sum whose largest term is 1).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a / d from r = 1 / d and one Newton step: the correctly rounded quotient
// (as a / d) for the normal operands here, without the division's slow
// path, whose branch would make ptxas serialize every wgmma.
__device__ __forceinline__ float quotient(float a, float d, float r) {
  const float q = a * r;
  return fmaf(fmaf(-q, d, a), r, q);
}

// Two floats as bf16x2: lo in the low half (the lower column index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 128, f32) (+)= A (64 x 16, shared) B (16 x 128, shared), both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, registers) B (16 x 64, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 112, f32) += A (64 x 16, registers) B (16 x 112, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n112(float (&d)[56], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, registers) B (16 x 128, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (D == 64) {
    wgmma_rs_n64(d, a, desc_b);
  } else if constexpr (D == 112) {
    wgmma_rs_n112(d, a, desc_b);
  } else {
    wgmma_rs_n128(d, a, desc_b);
  }
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
    wgmma_pv<D>(acc, pa[kk], desc_sw128(v_tile + kk * 16 * 128, kPanelBytes, 1024));
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

// P rounded to bf16 in place: the accumulator's blocks 2 kk and 2 kk + 1 are
// k-step kk's A fragment.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[8][4], const float (&s)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The warpgroup index, warp-uniform in the compiler's eyes.
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
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
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
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
      pack_p(pa, s);
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
        pack_p(pa, s);
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

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (D, rows, heads) bf16 tensor map read in boxes of {64, 128, 1} with the
// 128-byte swizzle; boxes past the tensor's end read zeros.
static bool make_map(CUtensorMap* map, const void* ptr, int d, int rows, int heads) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {kPanelCols, 128, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
           int hq, int hkv, int sq, int skv, float scale, int causal, int has_window,
           int window, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(&tm_q, q, D, sq, batch * hq) || !make_map(&tm_k, k, D, skv, batch * hkv) ||
      !make_map(&tm_v, v, D, skv, batch * hkv))
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
// {64, 112, 128}, 16-byte aligned; returns a cudaError_t as int
// (cudaErrorInvalidValue for any other D or a tensor map that does not
// encode, cudaErrorNotSupported without cuTensorMapEncodeTiled).  No
// synchronisation.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                float* lse, int batch, int hq, int hkv, int sq, int skv,
                                int d, float scale, int causal, int has_window, int window,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 128)
    return flash::launch<128>(q, k, v, o, lse, batch, hq, hkv, sq, skv, scale, causal,
                              has_window, window, st);
  if (d == 112)
    return flash::launch<112>(q, k, v, o, lse, batch, hq, hkv, sq, skv, scale, causal,
                              has_window, window, st);
  if (d == 64)
    return flash::launch<64>(q, k, v, o, lse, batch, hq, hkv, sq, skv, scale, causal,
                             has_window, window, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
