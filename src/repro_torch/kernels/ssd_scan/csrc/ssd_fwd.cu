// Mamba-2 SSD chunked scan, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_scan/kernel.py:
//   ssd_fwd (_ssd_kernel) -> ssd_fwd_launch
// Layout as the Pallas kernel's: x (B, H, S, P) bf16; dt, dA (B, H, S) f32
// (dA = dt * A[h] <= 0); Bm, Cm (B, G, S, N) bf16, head h reading group
// h / (H / G).  Outputs y (B, H, S, P) bf16 (without the D * x skip, which
// ops.py adds) and the final state (B, H, N, P) f32.
//
// What bounds it: operations.  Per chunk of 256 steps a (b, h) does
// C·Bᵀ (256 x 256 x N), the masked scores times x (256 x 256 x P), the
// carried-state term C·state (256 x N x P) and the state update
// Bᵀ·(x * w) (N x 256 x P): 33.6 MFLOP at N=128, P=64, so 6.9e10 FLOP for
// the Mamba2-1.3B prefill (B=4, H=64, S=2048) against about 151 MB of
// bytes.  C·Bᵀ runs on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulation: the inputs are bf16, so the products are exact and only the
// order of the sums differs); everything else runs in f32 on the CUDA
// cores, as the Pallas kernel computes it in f32.
//
// Design.  One CTA of 8 warps per (b, h) walks the chunks in order and
// carries the (N, P) f32 state in shared memory: the TPU grid's sequential
// chunk axis becomes this loop.  Per chunk it
//   1. loads dt and dA and takes the cumulative sum of dA with a warp scan
//      (shuffles) and a pass over the 8 warp totals;
//   2. stages the chunk's B (C x N) and x (C x P) in shared memory;
//   3. walks the chunk in t-blocks of 64 rows, so no (256, 256) score tile
//      is ever held (it would be 256 KB): for t-block i it stages C_i, starts
//      y_i at exp(cum_t) * (C_i · state), and for each s-block j <= i
//      computes the 64 x 64 tile C_i · B_jᵀ on the tensor cores, applies
//      L[t, s] * dt[s] with a SELECT (t >= s ? (cb * exp(cum_t - cum_s)) *
//      dt_s : 0; above the diagonal the exponent is positive and could
//      overflow, and inf * 0 would be NaN), writes the tile to shared memory
//      and adds tile · x_j to y_i (register-tiled f32, 4 x 4 a thread);
//   4. updates the state: exp(cum_last) * state + Bᵀ · (x * w), w_s =
//      exp(cum_last - cum_s) * dt_s.
// A chunk shorter than a multiple of 64 (any chunk up to 256) is padded with
// zero dt, dA, B, C and x, which contribute exactly nothing; N up to 128 and
// P up to 64 (multiples of 8) are padded the same way.  Shared memory at
// N=128: state 32 KB, B 68 KB, x 32 KB, C_i 17 KB, the score tile 17 KB:
// about 170 KB, one CTA an SM.  Simple on purpose: no cp.async, no wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ssd {

constexpr int kThreads = 256;  // 8 warps
constexpr int kTB = 64;        // rows of a t-block (and an s-block)
constexpr int kMaxChunk = 256;
constexpr int kP = 64;         // padded head dim
constexpr int kSStride = kTB + 4;  // f32 score tile row stride

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four bf16 (8 bytes) as floats.
__device__ __forceinline__ float4 ld_bf16x4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

// Copy `rows` rows of `cols` bf16 (cols % 8 == 0) from global (row stride
// `gstride`) into shared memory (row stride `sstride`), `prows` x `pcols`
// of it, zero where the source has no element.  16-byte chunks.
__device__ __forceinline__ void load_tile(__nv_bfloat16* s, int sstride, const __nv_bfloat16* g,
                                          int gstride, int rows, int cols, int prows,
                                          int pcols) {
  const int per_row = pcols / 8;
  for (int c = threadIdx.x; c < prows * per_row; c += kThreads) {
    const int row = c / per_row;
    const int col = (c % per_row) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows && col < cols)
      val = *reinterpret_cast<const uint4*>(g + (size_t)row * gstride + col);
    *reinterpret_cast<uint4*>(s + row * sstride + col) = val;
  }
}

template <int NP>  // padded state dim: 64 or 128
struct Layout {
  static constexpr int kNS = NP + 8;  // bf16 row stride of B and C (conflict-free fragments)
  static constexpr size_t kState = (size_t)NP * kP * 4;
  static constexpr size_t kB = (size_t)kMaxChunk * kNS * 2;
  static constexpr size_t kX = (size_t)kMaxChunk * kP * 2;
  static constexpr size_t kC = (size_t)kTB * kNS * 2;
  static constexpr size_t kS = (size_t)kTB * kSStride * 4;
  static constexpr size_t kVec = (size_t)4 * kMaxChunk * 4 + 8 * 4;
  static constexpr size_t kBytes = kState + kB + kX + kC + kS + kVec;
};

template <int NP>
__global__ void __launch_bounds__(kThreads, 1) ssd_fwd_kernel(
    const __nv_bfloat16* __restrict__ x,   // (B, H, S, P)
    const float* __restrict__ dt,          // (B, H, S)
    const float* __restrict__ da,          // (B, H, S)
    const __nv_bfloat16* __restrict__ bm,  // (B, G, S, N)
    const __nv_bfloat16* __restrict__ cm,  // (B, G, S, N)
    __nv_bfloat16* __restrict__ y,         // (B, H, S, P)
    float* __restrict__ final_state,       // (B, H, N, P)
    int n_heads, int n_groups, int seqlen, int n, int p, int chunk) {
  using L = Layout<NP>;
  constexpr int kNS = L::kNS;
  constexpr int kRN = NP / 16;  // state rows a thread updates
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_state = reinterpret_cast<float*>(smem);
  __nv_bfloat16* s_b = reinterpret_cast<__nv_bfloat16*>(smem + L::kState);
  __nv_bfloat16* s_x = reinterpret_cast<__nv_bfloat16*>(smem + L::kState + L::kB);
  __nv_bfloat16* s_c = reinterpret_cast<__nv_bfloat16*>(smem + L::kState + L::kB + L::kX);
  float* s_s = reinterpret_cast<float*>(smem + L::kState + L::kB + L::kX + L::kC);
  float* s_cum = reinterpret_cast<float*>(smem + L::kState + L::kB + L::kX + L::kC + L::kS);
  float* s_dt = s_cum + kMaxChunk;
  float* s_ecum = s_dt + kMaxChunk;   // exp(cum_t)
  float* s_w = s_ecum + kMaxChunk;    // exp(cum_last - cum_s) * dt_s
  float* s_warp = s_w + kMaxChunk;    // the 8 warp totals of the scan

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int grp = h / (n_heads / n_groups);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ty = tid >> 4;  // 0..15: row group of the register tiles
  const int tx = tid & 15;  // 0..15: column group (4 columns)
  const int g = lane >> 2;  // mma fragment row group
  const int tq = lane & 3;  // thread in the group
  const int wm = warp & 3;  // the warp's 16 score rows
  const int wn = warp >> 2; // the warp's 32 score columns
  const int cp = (chunk + kTB - 1) / kTB * kTB;  // chunk padded to t-blocks

  const size_t bh = (size_t)b * n_heads + h;
  const __nv_bfloat16* xb = x + bh * seqlen * p;
  const float* dtb = dt + bh * seqlen;
  const float* dab = da + bh * seqlen;
  const size_t bg = (size_t)b * n_groups + grp;
  const __nv_bfloat16* bb = bm + bg * seqlen * n;
  const __nv_bfloat16* cb = cm + bg * seqlen * n;
  __nv_bfloat16* yb = y + bh * seqlen * p;

  for (int i = tid; i < NP * kP; i += kThreads) s_state[i] = 0.f;

  for (int t0 = 0; t0 < seqlen; t0 += chunk) {
    // 1. dt, dA and the cumulative sum of dA (zero past the chunk's end)
    float d_a = 0.f, d_t = 0.f;
    if (tid < chunk) {
      d_a = dab[t0 + tid];
      d_t = dtb[t0 + tid];
    }
    float v = d_a;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += o;
    }
    if (lane == 31) s_warp[warp] = v;
    // 2. B and x of the chunk
    load_tile(s_b, kNS, bb + (size_t)t0 * n, n, chunk, n, cp, NP);
    load_tile(s_x, kP, xb + (size_t)t0 * p, p, chunk, p, cp, kP);
    __syncthreads();
    for (int w = 0; w < warp; ++w) v += s_warp[w];
    s_cum[tid] = v;
    s_dt[tid] = d_t;
    s_ecum[tid] = expf(v);
    __syncthreads();
    const float cum_last = s_cum[chunk - 1];
    s_w[tid] = expf(cum_last - v) * d_t;
    // (s_w is read only after the next barrier)

    // 3. y, one t-block of 64 rows at a time
    for (int i = 0; i * kTB < chunk; ++i) {
      const int ti = i * kTB;
      load_tile(s_c, kNS, cb + (size_t)(t0 + ti) * n, n, chunk - ti, n, kTB, NP);
      __syncthreads();
      // y_i = exp(cum_t) * (C_i · state)
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
      for (int k = 0; k < NP; k += 8) {
        float cv[4][8];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint4 raw = *reinterpret_cast<const uint4*>(s_c + (ty * 4 + r) * kNS + k);
          const __nv_bfloat162* pr = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(pr[e]);
            cv[r][2 * e] = f.x;
            cv[r][2 * e + 1] = f.y;
          }
        }
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const float4 sv = *reinterpret_cast<const float4*>(s_state + (k + kk) * kP + tx * 4);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc[r][0] = fmaf(cv[r][kk], sv.x, acc[r][0]);
            acc[r][1] = fmaf(cv[r][kk], sv.y, acc[r][1]);
            acc[r][2] = fmaf(cv[r][kk], sv.z, acc[r][2]);
            acc[r][3] = fmaf(cv[r][kk], sv.w, acc[r][3]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = s_ecum[ti + ty * 4 + r];
        acc[r][0] *= e;
        acc[r][1] *= e;
        acc[r][2] *= e;
        acc[r][3] *= e;
      }

      for (int j = 0; j <= i; ++j) {
        const int sj = j * kTB;
        // scores C_i · B_jᵀ for the warp's 16 rows x 32 columns
        float sc[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NP / 16; ++kk) {
          const __nv_bfloat16* pa = s_c + (wm * 16 + g) * kNS + kk * 16 + 2 * tq;
          uint32_t a[4];
          a[0] = ld32(pa);
          a[1] = ld32(pa + 8 * kNS);
          a[2] = ld32(pa + 8);
          a[3] = ld32(pa + 8 * kNS + 8);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const __nv_bfloat16* pb = s_b + (sj + wn * 32 + nt * 8 + g) * kNS + kk * 16 + 2 * tq;
            mma_bf16_16816(sc[nt], a, ld32(pb), ld32(pb + 8));
          }
        }
        // the decay mask by select, then dt of the column; into s_s
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int tl = wm * 16 + g + (e >= 2 ? 8 : 0);
            const int sl = wn * 32 + nt * 8 + 2 * tq + (e & 1);
            const int t_abs = ti + tl;
            const int s_abs = sj + sl;
            float val = 0.f;
            if (t_abs >= s_abs)
              val = (sc[nt][e] * expf(s_cum[t_abs] - s_cum[s_abs])) * s_dt[s_abs];
            s_s[tl * kSStride + sl] = val;
          }
        }
        __syncthreads();
        // y_i += scores · x_j
        for (int s = 0; s < kTB; s += 4) {
          float4 sv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            sv[r] = *reinterpret_cast<const float4*>(s_s + (ty * 4 + r) * kSStride + s);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4 xv = ld_bf16x4(s_x + (sj + s + kk) * kP + tx * 4);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float w = kk == 0 ? sv[r].x : kk == 1 ? sv[r].y : kk == 2 ? sv[r].z : sv[r].w;
              acc[r][0] = fmaf(w, xv.x, acc[r][0]);
              acc[r][1] = fmaf(w, xv.y, acc[r][1]);
              acc[r][2] = fmaf(w, xv.z, acc[r][2]);
              acc[r][3] = fmaf(w, xv.w, acc[r][3]);
            }
          }
        }
        __syncthreads();  // s_s (and, after the last j, s_c) is rewritten next
      }
      // y rows of this t-block, in bf16
      if (tx * 4 < p) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int t = ti + ty * 4 + r;
          if (t < chunk) {
            __nv_bfloat162 lo = __floats2bfloat162_rn(acc[r][0], acc[r][1]);
            __nv_bfloat162 hi = __floats2bfloat162_rn(acc[r][2], acc[r][3]);
            uint2 out;
            out.x = *reinterpret_cast<uint32_t*>(&lo);
            out.y = *reinterpret_cast<uint32_t*>(&hi);
            *reinterpret_cast<uint2*>(yb + (size_t)(t0 + t) * p + tx * 4) = out;
          }
        }
      }
    }

    // 4. state = exp(cum_last) * state + Bᵀ · (x * w)
    {
      float acc[kRN][4];
#pragma unroll
      for (int r = 0; r < kRN; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
      for (int s = 0; s < chunk; ++s) {
        const float w = s_w[s];
        float4 xv = ld_bf16x4(s_x + s * kP + tx * 4);
        xv.x *= w;
        xv.y *= w;
        xv.z *= w;
        xv.w *= w;
        float bv[kRN];
#pragma unroll
        for (int r = 0; r < kRN; r += 4) {
          const float4 f = ld_bf16x4(s_b + s * kNS + ty * kRN + r);
          bv[r] = f.x;
          bv[r + 1] = f.y;
          bv[r + 2] = f.z;
          bv[r + 3] = f.w;
        }
#pragma unroll
        for (int r = 0; r < kRN; ++r) {
          acc[r][0] = fmaf(bv[r], xv.x, acc[r][0]);
          acc[r][1] = fmaf(bv[r], xv.y, acc[r][1]);
          acc[r][2] = fmaf(bv[r], xv.z, acc[r][2]);
          acc[r][3] = fmaf(bv[r], xv.w, acc[r][3]);
        }
      }
      const float decay = expf(cum_last);
#pragma unroll
      for (int r = 0; r < kRN; ++r) {
        float4* st = reinterpret_cast<float4*>(s_state + (ty * kRN + r) * kP + tx * 4);
        float4 old = *st;
        old.x = decay * old.x + acc[r][0];
        old.y = decay * old.y + acc[r][1];
        old.z = decay * old.z + acc[r][2];
        old.w = decay * old.w + acc[r][3];
        *st = old;
      }
    }
    __syncthreads();  // the next chunk reads the whole state and rewrites s_b, s_x
  }

  float* fs = final_state + bh * n * p;
  for (int i = tid; i < NP * kP; i += kThreads) {
    const int r = i / kP, c = i % kP;
    if (r < n && c < p) fs[(size_t)r * p + c] = s_state[i];
  }
}

template <int NP>
int launch(const void* x, const float* dt, const float* da, const void* bm, const void* cm,
           void* y, float* final_state, int batch, int n_heads, int n_groups, int seqlen,
           int n, int p, int chunk, cudaStream_t stream) {
  const size_t smem = Layout<NP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_heads, batch);
  ssd_fwd_kernel<NP><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), dt, da, static_cast<const __nv_bfloat16*>(bm),
      static_cast<const __nv_bfloat16*>(cm), static_cast<__nv_bfloat16*>(y), final_state,
      n_heads, n_groups, seqlen, n, p, chunk);
  return (int)cudaGetLastError();
}

}  // namespace ssd

// y, final_state = ssd_fwd(x, dt, dA, Bm, Cm) for the layout above; n and p
// multiples of 8 with n <= 128 and p <= 64, chunk in [1, 256] dividing
// seqlen, n_heads a multiple of n_groups.  Returns a cudaError_t as int
// (cudaErrorInvalidValue for shapes it does not take).  No synchronisation.
extern "C" int ssd_fwd_launch(const void* x, const float* dt, const float* da, const void* bm,
                              const void* cm, void* y, float* final_state, int batch,
                              int n_heads, int n_groups, int seqlen, int n, int p, int chunk,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n % 8 || p % 8 || n > 128 || p > ssd::kP || chunk < 1 || chunk > ssd::kMaxChunk ||
      seqlen % chunk || n_groups < 1 || n_heads % n_groups)
    return (int)cudaErrorInvalidValue;
  if (n <= 64)
    return ssd::launch<64>(x, dt, da, bm, cm, y, final_state, batch, n_heads, n_groups,
                           seqlen, n, p, chunk, st);
  return ssd::launch<128>(x, dt, da, bm, cm, y, final_state, batch, n_heads, n_groups, seqlen,
                          n, p, chunk, st);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
