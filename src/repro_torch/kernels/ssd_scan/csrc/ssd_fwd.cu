// Mamba-2 SSD chunked scan, forward, for Hopper (sm_90a): TMA, wgmma and
// the chunks in parallel.
//
// Replaces the TPU kernel repro/kernels/ssd_scan/kernel.py:
//   ssd_fwd (_ssd_kernel) -> ssd_fwd_launch (ssd_delta_kernel, ssd_state_kernel,
//                            then ssd_y_kernel)
// Layout as the Pallas kernel's: x (B, H, S, P) bf16; dt, dA (B, H, S) f32
// (dA = dt * A[h] <= 0); Bm, Cm (B, G, S, N) bf16, head h reading group
// h / (H / G).  Outputs y (B, H, S, P) bf16 (without the D * x skip, which
// ops.py adds) and the final state (B, H, N, P) f32.
//
// What bounds it: operations.  Per chunk of 256 steps a (b, h) does
// C·Bᵀ (256 x 256 x N, half of it visible), the masked scores times x
// (256 x 256 x P, half visible), the carried-state term C·state (256 x N x
// P) and the state update Bᵀ·(x * w) (N x 256 x P): about 6.9e10
// tensor-core operations for the Mamba2-1.3B prefill (B=4, H=64, S=2048,
// N=128, P=64), counting the three products with a float32 operand twice
// (below), against about 151 MB of inputs and outputs.
//
// Every product runs on wgmma, bf16 in, f32 sums.  C·Bᵀ has bf16 operands,
// so its products are exact.  The other three have one float32 operand (the
// masked scores, the state, x * w) and one bf16 operand (x, C, B); the
// float32 one is split into hi = bf16(v) and lo = bf16(v - hi), and two bf16
// products go into one f32 sum: hi + lo keeps about 16 bits of v's
// mantissa (relative error about 2^-17), against y's 8 in bf16.
//
// The recurrence over chunks, state_{c+1} = exp(cum_last_c) * state_c +
// Delta_c with Delta_c = Bᵀ·(x * w) of chunk c alone, is split so that every
// chunk's products run at once (B * H * S / chunk CTAs, 2,048 at the
// serving shape):
//   1. ssd_delta_kernel, a CTA a (chunk, h, b): cum = cumsum(dA) over the
//      chunk (a warp scan), decay_c = exp(cum_last) and
//      Delta_cᵀ (P x N) = (x * w)ᵀ · B with w_s = exp(cum_last - cum_s) dt_s,
//      written to device scratch in f32;
//   2. ssd_state_kernel, a thread a float4 of the state of a (b, h): walks
//      the chunks in order with the formula and the order of the two terms
//      of the sequential scan (fmaf(decay, state, Delta)) and writes
//      state_c, the state entering chunk c, to a second scratch buffer,
//      then the final state.  The recurrence is elementwise, so its
//      B * H * N * P / 4 threads read each increment and write each state
//      once: linear in S, at the rate of a copy.  (Written over the
//      increments instead, each line written just after it is read, the
//      same pass ran at well under half that rate.);
//   3. ssd_y_kernel, a CTA a (chunk, h, b): reads state_c, then for each
//      64-row t-block i of the chunk, y_i = exp(cum_t) * (C_i · state_c) +
//      sum over s-blocks j <= i of (L ∘ dt ∘ (C_i · B_jᵀ)) · x_j, where
//      L[t, s] = exp(cum_t - cum_s) for t >= s and is taken by a select
//      (above the diagonal the exponent is positive and could overflow, and
//      inf * 0 would be NaN).
// No sum is split across CTAs and nothing is added atomically, so two
// calls give the same bits.
//
// Operands sit in shared memory as 64-column panels of 128-byte rows in the
// 128-byte swizzle that TMA writes and wgmma reads (hopper.cuh).  x, B and C
// are read through 4-d tensor maps (D, chunk, S / chunk, heads) in boxes of
// 64 rows, so rows past a ragged chunk's end and columns past N or P read
// zeros, and add exactly nothing.  The split operands are written by the
// threads in the same swizzle: x * w in place of x (w depends on the row
// alone, so each 16-byte chunk of a row is scaled where it lies) with lo
// beside it, and state_cᵀ (P rows, N columns) as the K-major B operand of
// C·state.  Delta_cᵀ = (x * w)ᵀ · B reads both operands MN-major (the
// descriptor's transpose bits), so neither is ever transposed in memory.
// Shared memory at N = 128: C, B 64 KB each, x 32 KB, the state's hi and lo
// 16 KB each (ssd_y_kernel, about 195 KB); B 64 KB, x and its lo 32 KB each
// (ssd_delta_kernel, about 131 KB).  hopper.cuh's rules keep ptxas from
// serializing the wgmmas: the warpgroup index comes through a shuffle, the
// only branches around products test it and the launch's shape, and the
// masked stores come after the last product.  ssd_y_kernel gives each of
// its four warpgroups one 64-row t-block, and issues s-block j + 1's
// scores together with s-block j's product by x, so that the SM's one CTA
// (its shared memory) has products of several warpgroups in flight.
#include <math.h>

#include "../../csrc/hopper.cuh"

namespace ssd {

using namespace hopper;

constexpr int kThreads = 256;  // ssd_delta_kernel: two warpgroups
constexpr int kYThreads = 512;  // ssd_y_kernel: four warpgroups, one a t-block
constexpr int kTB = 64;        // rows of a t-block or an s-block: one TMA box
constexpr int kMaxChunk = 256;
constexpr int kP = 64;                           // padded head dim: one panel
constexpr int kChunkPanel = kMaxChunk * 128;     // a panel of a chunk's rows
constexpr int kStatePanel = kP * 128;            // a panel of the state's P rows
constexpr int kBoxBytes = kTB * 128;             // one TMA box
constexpr float kLog2e = 1.4426950408889634f;

// One box {64 columns, 64 rows, 1 chunk, 1 head} of a 4-d tensor map.
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int col, int row, int chunk, int head) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(chunk),
      "r"(head)
      : "memory");
}

// Make the threads' writes to shared memory visible to wgmma's reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D (64 x 64, f32) (+)= A (64 x 16, shared, MN-major) B (16 x 64, shared, MN-major).
__device__ __forceinline__ void wgmma_ss_tt_n64(float (&d)[32], uint64_t desc_a,
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// Two floats as bf16x2 hi and the bf16x2 lo of what hi leaves (a - hi is
// exact in f32).
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// The byte offset of (row, col) in a 64-column panel of 128-byte rows in
// the 128-byte swizzle: 16-byte chunk col / 8 of row r sits at chunk
// (col / 8) ^ (r % 8).
__device__ __forceinline__ uint32_t swizzled(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// The chunk's cum = cumsum(dA) and dt into shared memory (zero past the
// chunk's end, so cum stays at cum_last), one position a thread of the
// block's first kMaxChunk; returns cum_last.  Contains two __syncthreads.
__device__ __forceinline__ float chunk_scan(const float* dab, const float* dtb, int chunk,
                                            float* s_cum, float* s_dt, float* s_warp) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float d_a = 0.f, d_t = 0.f;
  if (tid < chunk) {
    d_a = dab[tid];
    d_t = dtb[tid];
  }
  float v = d_a;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += o;
  }
  if (lane == 31 && tid < kMaxChunk) s_warp[warp] = v;
  __syncthreads();
  if (tid < kMaxChunk) {
    for (int w = 0; w < warp; ++w) v += s_warp[w];
    s_cum[tid] = v;
    s_dt[tid] = d_t;
  }
  __syncthreads();
  return s_cum[chunk - 1];
}

// Issue the loads of the chunk's rows (ntb boxes a panel) of `panels`
// panels of the map at dst onto bar.
__device__ __forceinline__ void load_chunk(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                           int panels, int ntb, int chunk_idx, int head) {
  for (int p = 0; p < panels; ++p)
    for (int i = 0; i < ntb; ++i)
      tma_load4(dst + p * kChunkPanel + i * kBoxBytes, map, bar, p * kPanelCols, i * kTB,
                chunk_idx, head);
}

// ---------------------------------------------------------------------------
// 1. Delta_cᵀ = (x * w)ᵀ · B and decay_c, a CTA a (chunk, h, b)
// ---------------------------------------------------------------------------

template <int NP>  // padded state dim: 64 or 128
struct DeltaSmem {
  static constexpr int kPanels = NP / 64;
  static constexpr int kB = 0;
  static constexpr int kX = kB + kPanels * kChunkPanel;  // x, then hi = bf16(x w)
  static constexpr int kLo = kX + kChunkPanel;            // lo = bf16(x w - hi)
  static constexpr int kVec = kLo + kChunkPanel;          // cum, dt, w, warp totals
  static constexpr int kBar = kVec + (3 * kMaxChunk + 8) * 4;
  static constexpr int kBytes = kBar + 8 + 1024;          // + alignment slack
};

template <int NP>
__global__ void __launch_bounds__(kThreads, 1) ssd_delta_kernel(
    const __grid_constant__ CUtensorMap tm_x,  // (P, chunk, S / chunk, B*H)
    const __grid_constant__ CUtensorMap tm_b,  // (N, chunk, S / chunk, B*G)
    const float* __restrict__ dt,              // (B, H, S)
    const float* __restrict__ da,              // (B, H, S)
    float* __restrict__ delta,                 // (B*H, S / chunk, kP, NP): Delta_cᵀ
    float* __restrict__ decay,                 // (B*H, S / chunk): exp(cum_last)
    int n_heads, int n_groups, int seqlen, int chunk) {
  using L = DeltaSmem<NP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle's alignment
  uint8_t* gbase = smem_raw + (base - raw);
  float* s_cum = reinterpret_cast<float*>(gbase + L::kVec);
  float* s_dt = s_cum + kMaxChunk;
  float* s_w = s_dt + kMaxChunk;
  float* s_warp = s_w + kMaxChunk;
  const uint32_t bar = base + L::kBar;

  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int ntb = (chunk + kTB - 1) / kTB;
  const int bh = b * n_heads + h;
  const int bg = b * n_groups + h / (n_heads / n_groups);
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
    mbar_expect_tx(bar, (L::kPanels + 1) * ntb * kBoxBytes);
    load_chunk(base + L::kB, &tm_b, bar, L::kPanels, ntb, c, bg);
    load_chunk(base + L::kX, &tm_x, bar, 1, ntb, c, bh);
  }
  const size_t row0 = (size_t)bh * seqlen + (size_t)c * chunk;
  const float cum_last = chunk_scan(da + row0, dt + row0, chunk, s_cum, s_dt, s_warp);
  s_w[tid] = expf(cum_last - s_cum[tid]) * s_dt[tid];  // 0 past the chunk's end
  if (tid == 0) decay[(size_t)bh * n_chunks + c] = expf(cum_last);
  __syncthreads();
  mbar_wait(bar, 0);

  // x * w split into hi (in place of x) and lo, 16-byte chunk by chunk
  uint8_t* gx = gbase + L::kX;
  uint8_t* glo = gbase + L::kLo;
  for (int q = tid; q < ntb * kTB * 8; q += kThreads) {
    const float w = s_w[q >> 3];  // the chunk's row
    uint4 v = *reinterpret_cast<const uint4*>(gx + q * 16);
    uint4 lo;
    uint32_t* vh = reinterpret_cast<uint32_t*>(&v);
    uint32_t* vl = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&vh[k]));
      split_bf16(f.x * w, f.y * w, vh[k], vl[k]);
    }
    *reinterpret_cast<uint4*>(gx + q * 16) = v;
    *reinterpret_cast<uint4*>(glo + q * 16) = lo;
  }
  fence_async_shared();
  __syncthreads();

  // warpgroup g: Delta_cᵀ's columns 64 g .. 64 g + 63 (state rows), both
  // operands MN-major: A = (x w)ᵀ (P x s) and B = B (s x N)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg < L::kPanels) {
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    // one committed group a 64-row s-block, waited for before the next: a
    // group whose products span the runtime loop would let the loop's own
    // instructions touch the accumulator, and ptxas would serialize them
    for (int tb = 0; tb < ntb; ++tb) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t rows = (tb * kTB + kk * 16) * 128;
        const uint64_t desc_b =
            desc_sw128(base + L::kB + wg * kChunkPanel + rows, kChunkPanel, 1024);
        wgmma_ss_tt_n64(acc, desc_sw128(base + L::kX + rows, kChunkPanel, 1024), desc_b, 1);
        wgmma_ss_tt_n64(acc, desc_sw128(base + L::kLo + rows, kChunkPanel, 1024), desc_b, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    const int warp = (tid / 32) % 4;
    const int lane = tid % 32;
    const int r0 = warp * 16 + lane / 4;  // rows: head-dim index p
    const int col = 2 * (lane % 4);
    float* out = delta + ((size_t)bh * n_chunks + c) * kP * NP + wg * 64;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      *reinterpret_cast<float2*>(out + (size_t)r0 * NP + 8 * i + col) =
          make_float2(acc[4 * i], acc[4 * i + 1]);
      *reinterpret_cast<float2*>(out + (size_t)(r0 + 8) * NP + 8 * i + col) =
          make_float2(acc[4 * i + 2], acc[4 * i + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// 2. state_c, chunk by chunk, a thread a float4 of a (b, h)
// ---------------------------------------------------------------------------

constexpr int kStateThreads = 256;

template <int NP>
__global__ void __launch_bounds__(kStateThreads) ssd_state_kernel(
    const float* __restrict__ delta,  // (B*H, S / chunk, kP, NP): Delta_cᵀ
    const float* __restrict__ decay,  // (B*H, S / chunk)
    float* __restrict__ states,       // (B*H, S / chunk, kP, NP): state_cᵀ
    float* __restrict__ final_state,  // (B, H, N, P)
    int n_chunks, int n, int p) {
  constexpr int kStride = kP * NP / 4;           // float4s of one chunk's state
  constexpr int kRows = 4 * kStateThreads / NP;  // head-dim rows of a block
  __shared__ float s_fin[kRows * (NP + 1)];      // the block's final state, padded
  const int e4 = blockIdx.x * kStateThreads + threadIdx.x;  // float4 of the state
  const int bh = blockIdx.y;
  const size_t off = (size_t)bh * n_chunks * kStride + e4;
  const float4* d4 = reinterpret_cast<const float4*>(delta) + off;
  float4* s4 = reinterpret_cast<float4*>(states) + off;
  const float* g = decay + (size_t)bh * n_chunks;
  float4 st = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < n_chunks; ++c) {
    const float4 d = __ldg(d4 + (size_t)c * kStride);
    s4[(size_t)c * kStride] = st;
    const float gc = g[c];
    st = make_float4(fmaf(gc, st.x, d.x), fmaf(gc, st.y, d.y), fmaf(gc, st.z, d.z),
                     fmaf(gc, st.w, d.w));
  }
  // the final state (N, P) is the transpose: staged in shared memory, so
  // that consecutive threads write consecutive head-dim rows
  const int local = 4 * threadIdx.x;
  float* f = s_fin + (local / NP) * (NP + 1) + local % NP;
  f[0] = st.x;
  f[1] = st.y;
  f[2] = st.z;
  f[3] = st.w;
  __syncthreads();
  const int row0 = blockIdx.x * kRows;
  float* fs = final_state + (size_t)bh * n * p;
  for (int i = threadIdx.x; i < kRows * NP; i += kStateThreads) {
    const int sn = i / kRows;  // state index
    const int r = i % kRows;
    if (sn < n && row0 + r < p) fs[(size_t)sn * p + row0 + r] = s_fin[r * (NP + 1) + sn];
  }
}

// ---------------------------------------------------------------------------
// 3. y of the chunk from state_c, a CTA a (chunk, h, b)
// ---------------------------------------------------------------------------

template <int NP>
struct YSmem {
  static constexpr int kPanels = NP / 64;
  static constexpr int kC = 0;
  static constexpr int kB = kC + kPanels * kChunkPanel;
  static constexpr int kX = kB + kPanels * kChunkPanel;
  static constexpr int kHi = kX + kChunkPanel;             // state_cᵀ hi (P x N)
  static constexpr int kLo = kHi + kPanels * kStatePanel;  // state_cᵀ lo
  static constexpr int kVec = kLo + kPanels * kStatePanel;  // cum, dt, exp(cum), warp totals
  static constexpr int kBar = kVec + (3 * kMaxChunk + 8) * 4;
  static constexpr int kBytes = kBar + 8 + 1024;
};

// Issue (and commit) the scores C_i · B_jᵀ of t-block i (at c_rows) and
// s-block j into sc.
template <int NP>
__device__ __forceinline__ void issue_scores(float (&sc)[32], uint32_t c_rows, uint32_t b_tile,
                                             int j) {
#pragma unroll
  for (int kk = 0; kk < NP / 16; ++kk)
    wgmma_ss_n64(sc, desc_kmajor<kChunkPanel>(c_rows, kk),
                 desc_kmajor<kChunkPanel>(b_tile + j * kBoxBytes, kk), kk > 0);
  wgmma_commit();
}

// The scores of s-block j masked by select (t >= s; above the diagonal
// the exponent is positive and could overflow), decayed and scaled by dt
// of the column, split into the hi and lo A fragments of the product by x.
__device__ __forceinline__ void mask_split(const float (&sc)[32], int j, int t0, float cum0,
                                           float cum1, const float* s_cum, const float* s_dt,
                                           int col, uint32_t (&ah)[4][4],
                                           uint32_t (&al)[4][4]) {
  float v[32];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = e < 2 ? t0 : t0 + 8;
      const int s = j * kTB + 8 * k + col + (e & 1);
      const float decay = exp2_approx(((e < 2 ? cum0 : cum1) - s_cum[s]) * kLog2e);
      v[4 * k + e] = t >= s ? (sc[4 * k + e] * decay) * s_dt[s] : 0.f;
    }
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      split_bf16(v[8 * kk + 2 * q], v[8 * kk + 2 * q + 1], ah[kk][q], al[kk][q]);
  }
}

// Issue (and commit) acc += (hi + lo) · x_j.
__device__ __forceinline__ void issue_px(float (&acc)[32], const uint32_t (&ah)[4][4],
                                         const uint32_t (&al)[4][4], uint32_t x_tile, int j) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t desc_x = desc_sw128(x_tile + (j * kTB + kk * 16) * 128, kChunkPanel, 1024);
    wgmma_rs_n64(acc, ah[kk], desc_x);
    wgmma_rs_n64(acc, al[kk], desc_x);
  }
  wgmma_commit();
}

// y of t-block i into acc: exp(cum_t) * (C_i · state) + the visible
// s-blocks' (L ∘ dt ∘ (C_i · B_jᵀ)) · x_j.  The scores of s-block j + 1
// are on the tensor cores together with s-block j's product by x.
template <int NP>
__device__ __forceinline__ void y_block(float (&acc)[32], int i, uint32_t base,
                                        const float* s_cum, const float* s_dt,
                                        const float* s_ecum, int r0, int col) {
  using L = YSmem<NP>;
  const uint32_t c_rows = base + L::kC + i * kBoxBytes;
  float sc[32];
  uint32_t ah[4][4], al[4][4];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NP / 16; ++kk) {
    const uint64_t desc_c = desc_kmajor<kChunkPanel>(c_rows, kk);
    wgmma_ss_n64(acc, desc_c, desc_kmajor<kStatePanel>(base + L::kHi, kk), kk > 0);
    wgmma_ss_n64(acc, desc_c, desc_kmajor<kStatePanel>(base + L::kLo, kk), 1);
  }
  wgmma_commit();
  issue_scores<NP>(sc, c_rows, base + L::kB, 0);
  wgmma_wait_all();
  fence_regs(acc);
  fence_regs(sc);
  const int t0 = i * kTB + r0;  // this thread's rows t0 and t0 + 8
  const float e0 = s_ecum[t0];
  const float e1 = s_ecum[t0 + 8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    acc[4 * k] *= e0;
    acc[4 * k + 1] *= e0;
    acc[4 * k + 2] *= e1;
    acc[4 * k + 3] *= e1;
  }
  const float cum0 = s_cum[t0];
  const float cum1 = s_cum[t0 + 8];
  for (int j = 0; j < i; ++j) {
    mask_split(sc, j, t0, cum0, cum1, s_cum, s_dt, col, ah, al);
    wgmma_fence();
    issue_px(acc, ah, al, base + L::kX, j);
    issue_scores<NP>(sc, c_rows, base + L::kB, j + 1);
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(sc);
    fence_regs(ah);
    fence_regs(al);
  }
  mask_split(sc, i, t0, cum0, cum1, s_cum, s_dt, col, ah, al);
  wgmma_fence();
  issue_px(acc, ah, al, base + L::kX, i);
  wgmma_wait_all();
  fence_regs(acc);
  fence_regs(ah);
  fence_regs(al);
}

// Rows of t-block i of acc to y (bf16), those inside the chunk and P.
__device__ __forceinline__ void store_y(const float (&acc)[32], int i, __nv_bfloat16* yc,
                                        int chunk, int p, int r0, int col) {
  const int t0 = i * kTB + r0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (8 * k >= p) continue;
    if (t0 < chunk)
      *reinterpret_cast<uint32_t*>(yc + (size_t)t0 * p + 8 * k + col) =
          pack_bf16(acc[4 * k], acc[4 * k + 1]);
    if (t0 + 8 < chunk)
      *reinterpret_cast<uint32_t*>(yc + (size_t)(t0 + 8) * p + 8 * k + col) =
          pack_bf16(acc[4 * k + 2], acc[4 * k + 3]);
  }
}

template <int NP>
__global__ void __launch_bounds__(kYThreads, 1) ssd_y_kernel(
    const __grid_constant__ CUtensorMap tm_x,  // (P, chunk, S / chunk, B*H)
    const __grid_constant__ CUtensorMap tm_b,  // (N, chunk, S / chunk, B*G)
    const __grid_constant__ CUtensorMap tm_c,  // (N, chunk, S / chunk, B*G)
    const float* __restrict__ dt,              // (B, H, S)
    const float* __restrict__ da,              // (B, H, S)
    const float* __restrict__ state,           // (B*H, S / chunk, kP, NP): state_cᵀ
    __nv_bfloat16* __restrict__ y,             // (B, H, S, P)
    int n_heads, int n_groups, int seqlen, int p, int chunk) {
  using L = YSmem<NP>;
  constexpr int kVecs = kP * NP / 4 / kYThreads;  // float4 of the state a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  float* s_cum = reinterpret_cast<float*>(gbase + L::kVec);
  float* s_dt = s_cum + kMaxChunk;
  float* s_ecum = s_dt + kMaxChunk;
  float* s_warp = s_ecum + kMaxChunk;
  const uint32_t bar = base + L::kBar;

  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int ntb = (chunk + kTB - 1) / kTB;
  const int bh = b * n_heads + h;
  const int bg = b * n_groups + h / (n_heads / n_groups);
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
    mbar_expect_tx(bar, (2 * L::kPanels + 1) * ntb * kBoxBytes);
    load_chunk(base + L::kC, &tm_c, bar, L::kPanels, ntb, c, bg);
    load_chunk(base + L::kB, &tm_b, bar, L::kPanels, ntb, c, bg);
    load_chunk(base + L::kX, &tm_x, bar, 1, ntb, c, bh);
  }
  const size_t row0 = (size_t)bh * seqlen + (size_t)c * chunk;
  chunk_scan(da + row0, dt + row0, chunk, s_cum, s_dt, s_warp);
  if (tid < kMaxChunk) s_ecum[tid] = expf(s_cum[tid]);

  // state_cᵀ (P rows, N columns) as hi and lo, the K-major B operand of
  // C·state (while the loads land)
  const float4* s4 =
      reinterpret_cast<const float4*>(state + ((size_t)bh * n_chunks + c) * kP * NP);
#pragma unroll
  for (int v = 0; v < kVecs; ++v) {
    const float4 st = s4[tid + kYThreads * v];
    const int e = 4 * (tid + kYThreads * v);
    const int row = e / NP;  // head-dim index
    const int sn = e % NP;   // state index: 4 of one 16-byte chunk
    const uint32_t off = (sn / 64) * kStatePanel + swizzled(row, sn % 64);
    uint2 hi, lo;
    split_bf16(st.x, st.y, hi.x, lo.x);
    split_bf16(st.z, st.w, hi.y, lo.y);
    *reinterpret_cast<uint2*>(gbase + L::kHi + off) = hi;
    *reinterpret_cast<uint2*>(gbase + L::kLo + off) = lo;
  }
  fence_async_shared();
  __syncthreads();
  mbar_wait(bar, 0);

  // warpgroup g takes t-block g (i + 1 s-blocks)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg < ntb) {
    const int warp = (tid / 32) % 4;
    const int lane = tid % 32;
    const int r0 = warp * 16 + lane / 4;
    const int col = 2 * (lane % 4);
    float acc[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[k] = 0.f;
    y_block<NP>(acc, wg, base, s_cum, s_dt, s_ecum, r0, col);
    store_y(acc, wg, y + row0 * p, chunk, p, r0, col);
  }
}

// A (d, seqlen, heads) bf16 tensor viewed as (d, chunk, seqlen / chunk,
// heads), read in boxes {64, 64, 1, 1} with the 128-byte swizzle: rows past
// a chunk's end and columns past d read zeros.
static bool make_chunk_map(CUtensorMap* map, const void* ptr, int d, int chunk, int n_chunks,
                           int heads) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)chunk, (cuuint64_t)n_chunks,
                              (cuuint64_t)heads};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)chunk * d * 2,
                                 (cuuint64_t)n_chunks * chunk * d * 2};
  const cuuint32_t box[4] = {kPanelCols, kTB, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NP>
int launch(const void* x, const float* dt, const float* da, const void* bm, const void* cm,
           void* y, float* final_state, float* delta, float* decay, float* states, int batch,
           int n_heads, int n_groups, int seqlen, int n, int p, int chunk, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  const int n_chunks = seqlen / chunk;
  CUtensorMap tm_x, tm_b, tm_c;
  if (!make_chunk_map(&tm_x, x, p, chunk, n_chunks, batch * n_heads) ||
      !make_chunk_map(&tm_b, bm, n, chunk, n_chunks, batch * n_groups) ||
      !make_chunk_map(&tm_c, cm, n, chunk, n_chunks, batch * n_groups))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_delta_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, DeltaSmem<NP>::kBytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_y_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             YSmem<NP>::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_chunks, n_heads, batch);
  ssd_delta_kernel<NP><<<grid, kThreads, DeltaSmem<NP>::kBytes, stream>>>(
      tm_x, tm_b, dt, da, delta, decay, n_heads, n_groups, seqlen, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  static_assert(kP * NP / 4 % kStateThreads == 0, "whole blocks of the state's float4s");
  ssd_state_kernel<NP><<<dim3(kP * NP / 4 / kStateThreads, batch * n_heads), kStateThreads, 0,
                         stream>>>(delta, decay, states, final_state, n_chunks, n, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_y_kernel<NP><<<grid, kYThreads, YSmem<NP>::kBytes, stream>>>(
      tm_x, tm_b, tm_c, dt, da, states, static_cast<__nv_bfloat16*>(y), n_heads, n_groups,
      seqlen, p, chunk);
  return (int)cudaGetLastError();
}

}  // namespace ssd

// y, final_state = ssd_fwd(x, dt, dA, Bm, Cm) for the layout above; n and p
// multiples of 8 with n <= 128 and p <= 64, chunk in [1, 256] dividing
// seqlen, n_heads a multiple of n_groups; x, Bm and Cm 16-byte aligned.
// delta and states ((B*H, S / chunk, 64, 64 or 128) f32, 64 for n <= 64) and
// decay ((B*H, S / chunk) f32) are scratch that the caller allocates.  Three
// launches.  Returns a cudaError_t as int (cudaErrorInvalidValue for shapes
// it does not take, cudaErrorNotSupported without cuTensorMapEncodeTiled).
// No synchronisation.
extern "C" int ssd_fwd_launch(const void* x, const float* dt, const float* da, const void* bm,
                              const void* cm, void* y, float* final_state, float* delta,
                              float* decay, float* states, int batch, int n_heads,
                              int n_groups, int seqlen, int n, int p, int chunk,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n % 8 || p % 8 || n > 128 || p > ssd::kP || chunk < 1 || chunk > ssd::kMaxChunk ||
      seqlen % chunk || n_groups < 1 || n_heads % n_groups)
    return (int)cudaErrorInvalidValue;
  if (n <= 64)
    return ssd::launch<64>(x, dt, da, bm, cm, y, final_state, delta, decay, states, batch,
                           n_heads, n_groups, seqlen, n, p, chunk, st);
  return ssd::launch<128>(x, dt, da, bm, cm, y, final_state, delta, decay, states, batch,
                          n_heads, n_groups, seqlen, n, p, chunk, st);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
