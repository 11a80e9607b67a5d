// Per-expert SwiGLU FFN, forward, for Hopper (sm_90a): TMA, an mbarrier ring
// and wgmma; bf16 in, f32 sums.
//
// Replaces the TPU kernel repro/kernels/moe_gemm/kernel.py:
//   moe_ffn_fwd (_kernel) -> moe_gate_up_launch + moe_down_launch
// x (E, R, Dm) bf16, the dispatched rows of each expert (the wrapper folds
// the dispatch groups into R); wg, wu (E, Dm, Dff) and wd (E, Dff, Dm) bf16,
// row-major.  out (E, R, Dm) bf16 = (act · wd) with
// act = bf16(silu(x · wg) * (x · wu)), the two products in f32.
//
// Why two launches.  The Pallas kernel keeps a (128, Dm) f32 accumulator
// in VMEM across its Dff grid axis, so the (E, R, Dff) activations never
// reach memory.  At Dm = 6144 that accumulator is 3 MB; a Hopper CTA has
// at most 227 KB of shared memory and 64K registers, so it cannot be held.
// Here the gate-up kernel writes act (E, R, Dff) in bf16 to device memory
// and the down kernel reads it back: at the Mixtral-8x22B prefill (8 groups
// x 8 experts x cap 320 = 2560 rows an expert, Dff 16384) that
// intermediate is 671 MB, written once and read once (0.4 ms at 3.35 TB/s
// against about 12.5 ms of tensor work).  act is rounded to bf16 exactly
// where the Pallas kernel rounds it (kernel.py:46), before the down
// product, so both compute the same numbers up to the order of the sums.
//
// What bounds it: operations at prefill (6 * 20480 * 6144 * 16384 =
// 1.24e13 FLOP, 12.5 ms at 989 TFLOP/s) and bytes at decode (4.83 GB of
// Mixtral's expert weights a layer, 1.44 ms at 3.35 TB/s, for 8 rows an
// expert; 33.8 GB, 10.1 ms, for Kimi-K2's 384 experts).
//
// Both launches are one GEMM, C = A · B with A (R, K) row-major (x, or act)
// read K-major and B (K, N) row-major (wg and wu, or wd) read MN-major, so
// neither operand is ever transposed in memory.  A CTA owns kBM rows x kBN
// B columns of one expert and walks all of K in 64-deep steps:
//   * one producer warpgroup (setmaxnreg.dec to 24 registers where there
//     are two consumers) whose elected thread issues every TMA load into a
//     ring of kStages stages, each with a "full" mbarrier (the bytes
//     landed) and an "empty" one (every consumer warp is done with it): the
//     A tile (kBM rows x 64 K columns, one 128-byte-swizzled panel) and
//     kBN / 64 B panels (64 K rows x 64 N columns each);
//   * one or two consumer warpgroups of 64 rows each that run wgmma
//     m64nkBNk16, both operands from shared memory (B with the descriptor's
//     transpose bit), the f32 sums in registers for the whole of K, one
//     stage's products in flight while the next stage's wait runs.
// The gate-up B tile is kBN / 2 columns of wg beside the same kBN / 2
// columns of wu, so one product of width kBN yields h_g and h_u of those
// columns side by side in the accumulator, and the epilogue forms
// act = silu(h_g) * h_u with silu(v) = v * rcp(1 + 2^(-v log2 e)) on the
// special-function unit (no division with a slow path: hopper.cuh's note).
//
// Two tilings, picked by the wrapper from R (kernel.py's block_rows):
//   * prefill (R > 64): kBM = 128 (two consumers), kBN = 256, 4 stages of
//     48 KB; row tiles are the fastest grid axis, so the CTAs that share a
//     weight tile run together and read it once from memory.  Each CTA's
//     operands are 128 x 64 and 64 x 256 a step, 85 operations a byte.
//   * decode (R <= 64): the weights are read once and the rows are few, so
//     what counts is the bytes in flight.  kBM = 64 (one consumer; the A
//     box holds R rounded up to 8 rows, and the rows of the tile past it
//     feed only output rows that are never stored), kBN = 256 for gate-up
//     and 128 for down (Mixtral's Dm of 6144 in 256-wide tiles gives 8 x 24
//     CTAs, 1.45 waves of 132 SMs, the last part empty; 128 gives 2.9), and
//     as many stages as fit in 220 KB (5 or 9: 160 or 144 KB of weights in
//     flight an SM).  The tensor work is 64 rows where 8 are real; at
//     Kimi-K2's decode that is 2.2 ms against 10.1 ms of bytes, and it
//     overlaps the loads.
// Every output element is summed by one CTA in a fixed order: no split of
// K, no atomics, so two calls give the same bits.  Ragged edges: TMA fills
// what lies past R, K or N in an expert's plane with zeros (each expert is
// its own plane of a 3-d tensor map, so a box never reads the next
// expert's rows), and stores are masked.
#include <math.h>

#include "../../csrc/hopper.cuh"

namespace moe {

using namespace hopper;

constexpr int kBK = 64;                    // K of a stage: one panel of A
constexpr int kBPanelBytes = kBK * 128;    // a B panel: 64 K rows x 64 columns
constexpr int kSmemBudget = 220 * 1024;    // the ring's bytes at most
constexpr int kProducerRegs = 24;          // 128 x 24 + 256 x 240 = 64 K registers
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

template <int kConsumers, int kBN>
struct Config {
  static_assert(kConsumers == 1 || kConsumers == 2, "one or two consumer warpgroups");
  static_assert(kBN == 128 || kBN == 256, "B tiles of 128 or 256 columns");
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kBM = 64 * kConsumers;
  static constexpr int kABytes = kBM * 128;  // the A panel of a stage
  static constexpr int kBPanels = kBN / 64;
  static constexpr int kStageBytes = kABytes + kBPanels * kBPanelBytes;
  static constexpr int kStages = kSmemBudget / kStageBytes;
  static constexpr int kBars = kStages * kStageBytes;  // offsets in the 1024-aligned base
  static constexpr int kSmem = kBars + 16 * kStages + 1024;  // + alignment slack
};

// silu(v) = v / (1 + e^-v), as v * rcp(1 + 2^(-v log2 e)): both on the
// special-function unit.  v -> -inf gives 2^+inf = inf, rcp 0, and -0.
__device__ __forceinline__ float silu(float v) {
  return v * rcp_approx(1.f + exp2_approx(-v * kLog2e));
}

// out (E, rows, n) = A · B for one expert and tile; for the gate-up launch
// (kGateUp) act = bf16(silu(x · wg) * (x · wu)) with tm_b0 = wg, tm_b1 = wu
// and n = Dff, else out = bf16(act · wd) with tm_b0 = wd and n = Dm.
template <int kConsumers, int kBN, bool kGateUp>
__global__ void __launch_bounds__(Config<kConsumers, kBN>::kThreads, 1) ffn_kernel(
    const __grid_constant__ CUtensorMap tm_a,   // (K, rows, E): x or act
    const __grid_constant__ CUtensorMap tm_b0,  // (n, K, E): wg or wd
    const __grid_constant__ CUtensorMap tm_b1,  // (n, K, E): wu (gate-up only)
    __nv_bfloat16* __restrict__ out,            // (E, rows, n)
    int rows, int n, int k, int a_box_rows) {
  using C = Config<kConsumers, kBN>;
  constexpr int kCols = kGateUp ? kBN / 2 : kBN;  // output columns of a CTA
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's alignment
  const uint32_t bar_full = base + C::kBars;             // stage st at + 8 st
  const uint32_t bar_empty = bar_full + 8 * C::kStages;  // stage st at + 8 st

  const int m0 = blockIdx.x * C::kBM;
  const int n0 = blockIdx.y * kCols;
  const int e = blockIdx.z;
  const int ktiles = (k + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, 4 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // The warpgroup index, warp-uniform in the compiler's eyes.
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    // ---- producer: one thread issues every load ----
    if constexpr (kConsumers == 2) setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      const uint32_t tx = a_box_rows * 128 + C::kBPanels * kBPanelBytes;
      int st = 0;
      uint32_t phase = 0;
#pragma unroll 1
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(bar_empty + 8 * st, phase ^ 1);  // round 0 passes at once
        const uint32_t full = bar_full + 8 * st;
        const uint32_t stage = base + st * C::kStageBytes;
        const uint32_t b = stage + C::kABytes;
        mbar_expect_tx(full, tx);
        tma_load(stage, &tm_a, full, kt * kBK, m0, e);
        if constexpr (kGateUp) {
#pragma unroll
          for (int p = 0; p < C::kBPanels / 2; ++p) {
            tma_load(b + p * kBPanelBytes, &tm_b0, full, n0 + 64 * p, kt * kBK, e);
            tma_load(b + (C::kBPanels / 2 + p) * kBPanelBytes, &tm_b1, full, n0 + 64 * p,
                     kt * kBK, e);
          }
        } else {
#pragma unroll
          for (int p = 0; p < C::kBPanels; ++p)
            tma_load(b + p * kBPanelBytes, &tm_b0, full, n0 + 64 * p, kt * kBK, e);
        }
        if (++st == C::kStages) {
          st = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: 64 rows each ----
    if constexpr (kConsumers == 2) setmaxnreg_inc<kConsumerRegs>();
    const int cw = role - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    float acc[kBN / 2];  // kBN / 8 blocks of 8 columns, 4 values a thread each
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;

    int st = 0;
    uint32_t phase = 0;
    uint32_t held = 0;  // the empty barrier of the stage whose products are in flight
#pragma unroll 1
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(bar_full + 8 * st, phase);
      const uint32_t stage = base + st * C::kStageBytes;
      const uint32_t a_rows = stage + cw * 64 * 128;  // this consumer's rows of the A panel
      const uint32_t b = stage + C::kABytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_ss_mn<kBN>(acc, desc_kmajor<C::kABytes>(a_rows, kk),
                         desc_mnmajor<kBPanelBytes>(b, kk));
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      fence_regs(acc);
      if (kt > 0 && lane == 0) mbar_arrive(held);  // this warp is done with it
      held = bar_empty + 8 * st;
      if (++st == C::kStages) {
        st = 0;
        phase ^= 1;
      }
    }
    wgmma_wait_all();
    fence_regs(acc);

    // ---- epilogue: this thread's rows r0 and r0 + 8, columns 8 i + col ----
    const int r0 = m0 + cw * 64 + warp * 16 + lane / 4;
    const int r1 = r0 + 8;
    const int col = 2 * (lane % 4);
    __nv_bfloat16* ob = out + (size_t)e * rows * n;
#pragma unroll
    for (int i = 0; i < kCols / 8; ++i) {
      const int c = n0 + 8 * i + col;  // n is a multiple of 8, so c + 1 < n with c
      uint32_t v0, v1;
      if constexpr (kGateUp) {  // h_g in blocks [0, kBN / 16), h_u in the next kBN / 16
        constexpr int u = kBN / 4;
        v0 = pack_bf16(silu(acc[4 * i]) * acc[u + 4 * i],
                       silu(acc[4 * i + 1]) * acc[u + 4 * i + 1]);
        v1 = pack_bf16(silu(acc[4 * i + 2]) * acc[u + 4 * i + 2],
                       silu(acc[4 * i + 3]) * acc[u + 4 * i + 3]);
      } else {
        v0 = pack_bf16(acc[4 * i], acc[4 * i + 1]);
        v1 = pack_bf16(acc[4 * i + 2], acc[4 * i + 3]);
      }
      if (c < n) {
        if (r0 < rows) *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * n + c) = v0;
        if (r1 < rows) *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * n + c) = v1;
      }
    }
  }
}

template <int kConsumers, int kBN, bool kGateUp>
int launch(const void* a, const void* b0, const void* b1, void* out, int experts, int rows,
           int n, int k, cudaStream_t stream) {
  using C = Config<kConsumers, kBN>;
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  // one consumer: the A box holds the rows rounded up to 8, at most 64
  const int a_box_rows = kConsumers == 2 || rows >= C::kBM ? C::kBM : (rows + 7) & ~7;
  CUtensorMap tm_a, tm_b0, tm_b1;
  if (!make_map(&tm_a, a, k, rows, experts, a_box_rows) ||
      !make_map(&tm_b0, b0, n, k, experts, kBK) ||
      !make_map(&tm_b1, kGateUp ? b1 : b0, n, k, experts, kBK))
    return (int)cudaErrorInvalidValue;
  auto kernel = ffn_kernel<kConsumers, kBN, kGateUp>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  constexpr int kCols = kGateUp ? kBN / 2 : kBN;
  const dim3 grid((rows + C::kBM - 1) / C::kBM, (n + kCols - 1) / kCols, experts);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(tm_a, tm_b0, tm_b1,
                                                  static_cast<__nv_bfloat16*>(out), rows, n, k,
                                                  a_box_rows);
  return (int)cudaGetLastError();
}

bool shapes_ok(int experts, int rows, int dm, int dff) {
  return experts >= 1 && experts <= 65535 && rows >= 1 && dm >= 8 && dff >= 8 &&
         dm % 8 == 0 && dff % 8 == 0;
}

}  // namespace moe

// act (E, R, Dff) = bf16(silu(x · wg) * (x · wu)) with CTAs of block_rows
// rows (64 or 128) and B tiles of 256 columns (128 of wg, 128 of wu); Dm
// and Dff multiples of 8, every pointer 16-byte aligned.  Returns a cudaError_t as int
// (cudaErrorInvalidValue for shapes or tiles it does not take,
// cudaErrorNotSupported without cuTensorMapEncodeTiled).  No
// synchronisation.
extern "C" int moe_gate_up_launch(const void* x, const void* wg, const void* wu, void* act,
                                  int experts, int rows, int dm, int dff, int block_rows,
                                  void* stream) {
  if (!moe::shapes_ok(experts, rows, dm, dff)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block_rows == 128)
    return moe::launch<2, 256, true>(x, wg, wu, act, experts, rows, dff, dm, st);
  if (block_rows == 64)
    return moe::launch<1, 256, true>(x, wg, wu, act, experts, rows, dff, dm, st);
  return (int)cudaErrorInvalidValue;
}

// out (E, R, Dm) = act · wd, summed in f32 over all of Dff, stored in bf16,
// with CTAs of block_rows rows (64 or 128) and B tiles of 128 or 256
// columns (wd's) respectively.
extern "C" int moe_down_launch(const void* act, const void* wd, void* out, int experts,
                               int rows, int dm, int dff, int block_rows, void* stream) {
  if (!moe::shapes_ok(experts, rows, dm, dff)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block_rows == 128)
    return moe::launch<2, 256, false>(act, wd, nullptr, out, experts, rows, dm, dff, st);
  if (block_rows == 64)
    return moe::launch<1, 128, false>(act, wd, nullptr, out, experts, rows, dm, dff, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
