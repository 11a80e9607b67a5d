// Per-expert SwiGLU FFN, forward, for Hopper (sm_90a): bf16 in, f32 sums.
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
// expert weights a layer, 1.44 ms at 3.35 TB/s, for 8 rows an expert).
// Both kernels are one tiled GEMM main loop: a CTA of 8 warps owns a
// (128 rows x BN columns) output tile of one expert and walks K in steps
// of 32 through a 3-stage cp.async ring in shared memory; warps load
// fragments with ldmatrix (.trans for the row-major weights) and multiply
// with mma.sync m16n8k16 bf16 -> f32, the sums staying in registers over
// the whole K (so the down kernel accumulates over all of Dff in registers
// per (row tile, Dm tile)).  Ragged rows (cap 320 or 8 is no multiple of
// 128), columns and K are predicated: cp.async zero-fills what lies past
// an edge, and stores are masked.  Row tiles are the fastest grid axis, so
// the CTAs that share a weight tile run together and read it once from
// memory.  Simple on purpose: no wgmma, no TMA, no warp specialisation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace moe {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBM = 128;       // rows of a CTA tile
constexpr int kBK = 32;        // K of a stage
constexpr int kStages = 3;
constexpr int kAStride = kBK + 8;  // bf16; 80-byte rows keep ldmatrix conflict-free

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !pred.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// A CTA's GEMM: acc[b] (its warp's MT x NT fragments) = A[rows m0.., :K] ·
// W_b[:K, cols n0..] for NB weight matrices sharing A.  A is (M, K) and each
// W_b is (K, N), row-major bf16, K % 8 == 0 and N % 8 == 0.
template <int WM, int WN, int MT, int NT, int NB>
struct Gemm {
  static constexpr int kBN = WN * NT * 8;
  static constexpr int kWStride = kBN + 8;  // bf16
  static constexpr int kAElems = kBM * kAStride;
  static constexpr int kWElems = kBK * kWStride;
  static constexpr int kStageElems = kAElems + NB * kWElems;
  static constexpr size_t kSmemBytes = (size_t)kStages * kStageElems * 2;
  static_assert(WM * MT * 16 == kBM, "warps x m-tiles must cover the row tile");
  static_assert(WM * WN * 32 == kThreads, "8 warps");
  static_assert(NT % 2 == 0, "ldmatrix.x4.trans loads two n-tiles");

  __device__ static void load_stage(__nv_bfloat16* st, const __nv_bfloat16* a,
                                    const __nv_bfloat16* const* w, int m0, int n0, int k0,
                                    int m, int n, int k) {
    // A: kBM rows x kBK columns, 4 chunks of 8 a row
    for (int c = threadIdx.x; c < kBM * (kBK / 8); c += kThreads) {
      const int row = c / (kBK / 8);
      const int col = (c % (kBK / 8)) * 8;
      const bool ok = m0 + row < m && k0 + col < k;
      const __nv_bfloat16* src = ok ? a + (size_t)(m0 + row) * k + k0 + col : a;
      cp_async16(st + row * kAStride + col, src, ok);
    }
    // W_b: kBK rows x kBN columns
#pragma unroll
    for (int bi = 0; bi < NB; ++bi) {
      __nv_bfloat16* ws = st + kAElems + bi * kWElems;
      for (int c = threadIdx.x; c < kBK * (kBN / 8); c += kThreads) {
        const int row = c / (kBN / 8);
        const int col = (c % (kBN / 8)) * 8;
        const bool ok = k0 + row < k && n0 + col < n;
        const __nv_bfloat16* src = ok ? w[bi] + (size_t)(k0 + row) * n + n0 + col : w[bi];
        cp_async16(ws + row * kWStride + col, src, ok);
      }
    }
  }

  __device__ static void run(float (&acc)[NB][MT][NT][4], __nv_bfloat16* smem,
                             const __nv_bfloat16* a, const __nv_bfloat16* const* w, int m0,
                             int n0, int m, int n, int k) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int wm = warp % WM;
    const int wn = warp / WM;
#pragma unroll
    for (int bi = 0; bi < NB; ++bi)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) acc[bi][i][j][0] = acc[bi][i][j][1] = acc[bi][i][j][2] =
            acc[bi][i][j][3] = 0.f;

    const int ktiles = (k + kBK - 1) / kBK;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < ktiles) load_stage(smem + s * kStageElems, a, w, m0, n0, s * kBK, m, n, k);
      cp_async_commit();
    }
    // ldmatrix lane addressing: rows lane % 16, column half lane / 16
    const int lrow = lane & 15;
    const int lcol = (lane >> 4) * 8;
    for (int kt = 0; kt < ktiles; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      const int nk = kt + kStages - 1;  // refills the stage computed last iteration
      if (nk < ktiles)
        load_stage(smem + (nk % kStages) * kStageElems, a, w, m0, n0, nk * kBK, m, n, k);
      cp_async_commit();

      const __nv_bfloat16* as = smem + (kt % kStages) * kStageElems;
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        uint32_t af[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          ldmatrix_x4(af[i], as + (wm * MT * 16 + i * 16 + lrow) * kAStride + ks * 16 + lcol);
#pragma unroll
        for (int bi = 0; bi < NB; ++bi) {
          const __nv_bfloat16* ws = as + kAElems + bi * kWElems;
#pragma unroll
          for (int j = 0; j < NT; j += 2) {
            uint32_t bf[4];  // b0, b1 of n-tile j, then of n-tile j + 1
            ldmatrix_x4_trans(bf, ws + (ks * 16 + lrow) * kWStride + wn * NT * 8 + j * 8 + lcol);
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              mma_bf16_16816(acc[bi][i][j], af[i], bf[0], bf[1]);
              mma_bf16_16816(acc[bi][i][j + 1], af[i], bf[2], bf[3]);
            }
          }
        }
      }
    }
    cp_async_wait<0>();
  }
};

// The gate-up GEMM: 4 x 2 warps, each 32 rows x 32 columns of h_g and h_u.
using GateUp = Gemm<4, 2, 2, 4, 2>;
// The down GEMM: 2 x 4 warps, each 64 rows x 32 columns.
using Down = Gemm<2, 4, 4, 4, 1>;

// Store a warp's fragments (value(i, j, e) of m-tile i, n-tile j, element
// e) as bf16 pairs into the
// (m, n) row-major `out`, masked at the edges.
template <int WM, int MT, int NT, typename F>
__device__ __forceinline__ void store_tile(__nv_bfloat16* out, int m0, int n0, int m, int n,
                                           F value) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp % WM;
  const int wn = warp / WM;
  const int g = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0 + wn * NT * 8 + j * 8 + 2 * tq;
      if (col >= n) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * MT * 16 + i * 16 + g + half * 8;
        if (row >= m) continue;
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(value(i, j, 2 * half), value(i, j, 2 * half + 1));
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * n + col) = v;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) gate_up_kernel(
    const __nv_bfloat16* __restrict__ x,   // (E, R, Dm)
    const __nv_bfloat16* __restrict__ wg,  // (E, Dm, Dff)
    const __nv_bfloat16* __restrict__ wu,  // (E, Dm, Dff)
    __nv_bfloat16* __restrict__ act,       // (E, R, Dff)
    int rows, int dm, int dff) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * GateUp::kBN;
  const size_t e = blockIdx.z;
  const __nv_bfloat16* w[2] = {wg + e * dm * dff, wu + e * dm * dff};
  float acc[2][2][4][4];
  GateUp::run(acc, smem, x + e * rows * dm, w, m0, n0, rows, dff, dm);
  store_tile<4, 2, 4>(act + e * rows * dff, m0, n0, rows, dff,
                      [&](int i, int j, int v) { return silu(acc[0][i][j][v]) * acc[1][i][j][v]; });
}

__global__ void __launch_bounds__(kThreads) down_kernel(
    const __nv_bfloat16* __restrict__ act,  // (E, R, Dff)
    const __nv_bfloat16* __restrict__ wd,   // (E, Dff, Dm)
    __nv_bfloat16* __restrict__ out,        // (E, R, Dm)
    int rows, int dm, int dff) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * Down::kBN;
  const size_t e = blockIdx.z;
  const __nv_bfloat16* w[1] = {wd + e * dff * dm};
  float acc[1][4][4][4];
  Down::run(acc, smem, act + e * rows * dff, w, m0, n0, rows, dm, dff);
  store_tile<2, 4, 4>(out + e * rows * dm, m0, n0, rows, dm,
                      [&](int i, int j, int v) { return acc[0][i][j][v]; });
}

bool shapes_ok(int experts, int rows, int dm, int dff) {
  return experts >= 1 && experts <= 65535 && rows >= 1 && dm % 8 == 0 && dff % 8 == 0 &&
         dm >= 8 && dff >= 8 && dff / GateUp::kBN < 65535 && dm / Down::kBN < 65535;
}

template <typename G>
dim3 grid(int experts, int rows, int cols) {
  return dim3((rows + kBM - 1) / kBM, (cols + G::kBN - 1) / G::kBN, experts);
}

}  // namespace moe

// act (E, R, Dff) = bf16(silu(x · wg) * (x · wu)); Dm and Dff multiples of 8,
// every pointer 16-byte aligned.  Returns a cudaError_t as int
// (cudaErrorInvalidValue for shapes it does not take).  No synchronisation.
extern "C" int moe_gate_up_launch(const void* x, const void* wg, const void* wu, void* act,
                                  int experts, int rows, int dm, int dff, void* stream) {
  if (!moe::shapes_ok(experts, rows, dm, dff)) return (int)cudaErrorInvalidValue;
  const size_t smem = moe::GateUp::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(moe::gate_up_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  moe::gate_up_kernel<<<moe::grid<moe::GateUp>(experts, rows, dff), moe::kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wg),
      static_cast<const __nv_bfloat16*>(wu), static_cast<__nv_bfloat16*>(act), rows, dm, dff);
  return (int)cudaGetLastError();
}

// out (E, R, Dm) = act · wd, summed in f32 over all of Dff, stored in bf16.
extern "C" int moe_down_launch(const void* act, const void* wd, void* out, int experts,
                               int rows, int dm, int dff, void* stream) {
  if (!moe::shapes_ok(experts, rows, dm, dff)) return (int)cudaErrorInvalidValue;
  const size_t smem = moe::Down::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(moe::down_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  moe::down_kernel<<<moe::grid<moe::Down>(experts, rows, dm), moe::kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(act), static_cast<const __nv_bfloat16*>(wd),
      static_cast<__nv_bfloat16*>(out), rows, dm, dff);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
