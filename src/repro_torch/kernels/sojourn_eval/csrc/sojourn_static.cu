// Fused E[sojourn] of static orders: exact enumeration, streamed MC and
// explicit outcome tables.
//
// Replaces the TPU kernels of repro/kernels/sojourn_eval/kernel.py:
//   sojourn_enum     (_enum_kernel)     -> sojourn_enum_launch
//   sojourn_mc       (_mc_kernel)       -> sojourn_mc_launch
//   sojourn_outcomes (_outcomes_kernel) -> sojourn_outcomes_launch
//
// Inputs are pre-permuted by the caller: position pos of order p reads
// tables[p, pos, :], so the running sum t after pos steps is the
// completion time of the job served pos-th.  Everything is float64, as
// the JAX package computes under x64.  No kernel uses atomics: every block
// writes its partial sums and a second small kernel adds them in a fixed
// order (common.cuh), so two calls give the same bits.
#include "../../csrc/hopper.cuh"
#include "common.cuh"
#include "threefry.cuh"

namespace sojourn {

// ---------------------------------------------------------------------------
// Exact enumeration (sojourn_enum): service-order prefixes shared
// ---------------------------------------------------------------------------
//
// What bounds it: float64 operations.  A combination is one stop stage a
// position; its value needs the weight product, the completion times and
// their sums in service order, then the Eq. (7)/(9) tail (two divisions).
// The TPU kernel (and this port's first kernel) decoded every position of
// every combination from its index with an integer division and a modulo
// and recomputed all N positions: about 30 integer instructions and 3
// float64 operations a position.  Two combinations that agree on their
// first q service positions share that prefix's state, so this kernel
// walks the combinations in service order:
//
// * the first N - L positions (the prefix) are decoded once per thread,
//   from the thread's prefix index, with one division a position;
// * the last L positions (the suffix, L a template parameter up to
//   kMaxSuffix) are walked as an odometer of nested loops, the last
//   position fastest.  Each loop level keeps the state (w, t, tsum, tot,
//   cnt) of the positions before it in registers, so a digit change at
//   position q recomputes the state from q on: about M / (M - 1) position
//   updates a combination, and at the last position the mean tot / cnt of
//   a combination that does not succeed there is its parent's, divided
//   once.
//
// Each combination's value keeps its bits: the weight is the product in
// service order ((1 * p_0) * p_1) * ..., the completion times and their
// sums are added in the same order, and the tail is w * (tot / cnt) and
// w * (tsum / N).  Only the order in which a thread adds combinations into
// its accumulators differs from a walk by index.  The wrapper (kernel.py,
// suffix_length) picks L so that P x prefixes fills the card.
constexpr int kMaxSuffix = 8;

// The running state of a combination after some service positions.
struct Prefix {
  double w, t, tsum, tot;
  int cnt;
};

// Serve the next position at stop stage d (a success when it is the last).
__device__ __forceinline__ Prefix serve(Prefix s, double p, double size, bool success) {
  s.w *= p;
  s.t += size;
  s.tsum += s.t;
  if (success) {
    s.tot += s.t;
    ++s.cnt;
  }
  return s;
}

// Walk the Q positions left of the suffix from state s; sizes, probs and
// radix point at the first of them.
template <int Q>
__device__ __forceinline__ void walk_suffix(const double* sizes, const double* probs,
                                            const int* radix, int m, Prefix s, double dn,
                                            double& acc_succ, double& acc_all) {
  const int r = radix[0];
  if constexpr (Q == 1) {
    // the last position: a combination that stops before its last stage
    // has its parent's tot and cnt, so its mean is the parent's, bitwise
    const double mean0 = s.cnt > 0 ? s.tot / (double)s.cnt : 0.0;
#pragma unroll 1
    for (int d = 0; d < r; ++d) {
      const double w = s.w * probs[d];
      const double t = s.t + sizes[d];
      const double tsum = s.tsum + t;
      const double mean = d == r - 1 ? (s.tot + t) / (double)(s.cnt + 1) : mean0;
      acc_succ += w * mean;  // Eq. (7), weighted: Eq. (9)
      acc_all += w * (tsum / dn);
    }
  } else {
#pragma unroll 1
    for (int d = 0; d < r; ++d)
      walk_suffix<Q - 1>(sizes + m, probs + m, radix + 1, m,
                         serve(s, probs[d], sizes[d], d == r - 1), dn, acc_succ, acc_all);
  }
}

template <int L>
__global__ void __launch_bounds__(kThreads, 2) enum_kernel(
    const double* __restrict__ sizes_p,  // (P, N, M) permuted cumulative sizes
    const double* __restrict__ probs_p,  // (P, N, M) permuted stop probabilities
    const int* __restrict__ strides_p,   // (P, N) permuted mixed-radix strides (checked)
    const int* __restrict__ radix_p,     // (P, N) permuted stage counts
    int n, int m, long long k_total, int orders_on_x,
    double* __restrict__ partials) {     // (P, nblk, 2)
  extern __shared__ double smem[];
  __shared__ uint32_t s_prefixes;
  double* s_sizes = smem;
  double* s_probs = smem + n * m;
  int* s_radix = reinterpret_cast<int*>(smem + 2 * n * m);
  uint32_t* s_stride = reinterpret_cast<uint32_t*>(s_radix + n);  // prefix strides

  const GridPos g = grid_pos(orders_on_x);
  const size_t tab_off = (size_t)g.p * n * m;
  for (int i = threadIdx.x; i < n * m; i += blockDim.x) {
    s_sizes[i] = sizes_p[tab_off + i];
    s_probs[i] = probs_p[tab_off + i];
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) s_radix[i] = radix_p[(size_t)g.p * n + i];
  __syncthreads();
  // The caller's strides must be the mixed-radix strides of this order's
  // radix in some job order, and k_total its product (as the plain version
  // checks): sorted by stride (a radix of 1 first among equal ones), each
  // stride is the product of the radices sorted before it.  An order for
  // which this fails gives NaN.  Products stop past any valid count.
  constexpr long long kCap = 1ll << 40;
  bool bad = false;
  if (threadIdx.x < n) {
    const int i = threadIdx.x;
    const int* st = strides_p + (size_t)g.p * n;
    const long long key = 2ll * st[i] + (s_radix[i] != 1);
    long long before = 1;
    for (int j = 0; j < n; ++j) {
      const long long kj = 2ll * st[j] + (s_radix[j] != 1);
      if (kj < key || (kj == key && j < i)) before = min(before * s_radix[j], kCap);
    }
    bad = before != st[i];
  }
  if (threadIdx.x == 0) {
    long long all = 1;
    for (int j = 0; j < n; ++j) all = min(all * s_radix[j], kCap);
    bad |= all != k_total;
  }
  const bool mismatch = __syncthreads_or(bad);
  const int np = n - L;  // prefix positions
  if (threadIdx.x == 0) {  // mixed-radix strides of the prefix, last position fastest
    uint32_t stride = 1;
    for (int pos = np - 1; pos >= 0; --pos) {
      s_stride[pos] = stride;
      stride *= (uint32_t)s_radix[pos];
    }
    s_prefixes = stride;  // this order's prefixes: below 2^31, as K is
  }
  __syncthreads();

  const uint32_t prefixes = mismatch ? 0u : s_prefixes;
  const double dn = (double)n;
  double acc_succ = 0.0, acc_all = 0.0;
  const uint32_t step = (uint32_t)g.nblk * blockDim.x;
  for (uint32_t j = (uint32_t)g.b * blockDim.x + threadIdx.x; j < prefixes; j += step) {
    Prefix s{1.0, 0.0, 0.0, 0.0, 0};
    for (int pos = 0; pos < np; ++pos) {
      const int r = s_radix[pos];
      const int d = (int)((j / s_stride[pos]) % (uint32_t)r);
      s = serve(s, s_probs[pos * m + d], s_sizes[pos * m + d], d == r - 1);
    }
    if constexpr (L == 0) {
      acc_succ += s.w * (s.cnt > 0 ? s.tot / (double)s.cnt : 0.0);
      acc_all += s.w * (s.tsum / dn);
    } else {
      walk_suffix<L>(s_sizes + np * m, s_probs + np * m, s_radix + np, m, s, dn, acc_succ,
                     acc_all);
    }
  }
  if (mismatch) acc_succ = acc_all = nan("");
  write_partial(partials, g, acc_succ, acc_all);
}

template <int L>
int launch_enum(const double* sizes_p, const double* probs_p, const int* strides_p,
                const int* radix_p, int n_orders, int n, int m, long long k_total, int nblk,
                double* partials, double* out, cudaStream_t st) {
  int orders_on_x;
  const dim3 grid = make_grid(n_orders, nblk, &orders_on_x);
  const size_t smem = 2 * (size_t)n * m * sizeof(double) + 2 * (size_t)n * sizeof(int);
  enum_kernel<L><<<grid, kThreads, smem, st>>>(sizes_p, probs_p, strides_p, radix_p, n, m,
                                               k_total, orders_on_x, partials);
  return finish_launch(partials, nblk, n_orders, out, st);
}

// ---------------------------------------------------------------------------
// Streamed Monte Carlo (sojourn_mc)
// ---------------------------------------------------------------------------
//
// A lane decodes its sample from the Threefry stream (seed; x0 = sample,
// x1 = ORIGINAL job id; the .x word) and an inverse-CDF count.  What
// bounds it: integer issue.  A pair of job and sample needs one Threefry
// block, 19 rotates and 19 xors of which only the SM's 64-lane integer
// ALU pipe runs (the stream is fixed, so no kernel shares or shortens a
// block), against 3 float64 adds.  The TPU kernel (and this port's first
// kernel) also converted the bits to a float64 uniform and made M float64
// compares a pair.  This kernel decodes in the integer domain: u = bits *
// 2^-32 exactly, so u >= cdf holds exactly when bits >= ceil(cdf * 2^32).
// The wrapper (kernel.mc_tables) turns each position's CDF into its stop
// stage's base s0 (the stages that always pass, at most r - 1) and the
// sorted thresholds of the stages after it, minus one, as uint32 (2^32 - 1
// for one that never passes).  So the stop stage is s0 + (bits > t_0) +
// ... with no conversion and no float64 compare, the same stage bit for
// bit.  Each thread keeps two positions' blocks in flight (independent
// chains), the key schedule and each position's x1 = job + k1 hoisted,
// and serves the positions in service order: each sample's sums, and the
// grid-stride walk over samples, are those of the first kernel, bitwise.
//
// Position record (uint4, wrapper-made): {job + k1, s0, r - 1, t_0}; the
// thresholds t_1 .. t_{M-2} (M >= 3) in `extra` (N, M - 2).  A block
// copies its order's records and sizes into shared memory when they fit
// the card's limit (kShared), else reads them through L1 (__ldg).
template <int kS>
__device__ __forceinline__ int mc_stage(const uint4& rec, const uint32_t* extra, int slots,
                                        uint32_t bits) {
  int s = (int)rec.y + (bits > rec.w);
  if constexpr (kS == 0) {
    for (int i = 0; i < slots - 1; ++i) s += bits > extra[i];
  } else {
#pragma unroll
    for (int i = 0; i < kS - 1; ++i) s += bits > extra[i];
  }
  return s;
}

template <bool kShared, typename T>
__device__ __forceinline__ T mc_load(const T* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// One sample's running state, served position by position.
struct McState {
  double t, tsum, tot;
  int cnt;
};

template <int kS, bool kShared>
__device__ __forceinline__ void mc_serve(McState& st, const uint4& rec, const double* sizes,
                                         const uint32_t* extra, int pos, int m, int n_extra,
                                         int slots, uint32_t bits) {
  const int s = mc_stage<kS>(rec, extra + (size_t)pos * n_extra, slots, bits);
  st.t += mc_load<kShared>(sizes + pos * m + s);
  st.tsum += st.t;
  if (s == (int)rec.z) {  // success: stopped at the last stage
    st.tot += st.t;
    ++st.cnt;
  }
}

template <int kS, bool kShared>
__global__ void __launch_bounds__(kThreads) mc_kernel(
    const double* __restrict__ sizes_p,  // (P, N, M) permuted cumulative sizes
    const uint4* __restrict__ recs_p,    // (P, N) position records
    const uint32_t* __restrict__ extra_p,  // (P, N, M - 2) further thresholds
    int n, int m, long long count, uint32_t k0, uint32_t k1,
    uint32_t one,                        // 1: threefry2x32_x's run-time one
    int orders_on_x, double* __restrict__ partials) {  // (P, nblk, 2)
  extern __shared__ __align__(16) unsigned char mc_smem[];
  const GridPos g = grid_pos(orders_on_x);
  const int n_extra = m > 2 ? m - 2 : 0;
  const int slots = m > 1 ? m - 1 : 1;
  const double* sizes = sizes_p + (size_t)g.p * n * m;
  const uint4* recs = recs_p + (size_t)g.p * n;
  const uint32_t* extra = extra_p + (size_t)g.p * n * n_extra;
  if constexpr (kShared) {
    uint4* s_recs = reinterpret_cast<uint4*>(mc_smem);
    double* s_sizes = reinterpret_cast<double*>(s_recs + n);
    uint32_t* s_extra = reinterpret_cast<uint32_t*>(s_sizes + (size_t)n * m);
    for (int i = threadIdx.x; i < n; i += blockDim.x) s_recs[i] = recs[i];
    for (int i = threadIdx.x; i < n * m; i += blockDim.x) s_sizes[i] = sizes[i];
    for (int i = threadIdx.x; i < n * n_extra; i += blockDim.x) s_extra[i] = extra[i];
    __syncthreads();
    recs = s_recs;
    sizes = s_sizes;
    extra = s_extra;
  }

  const ThreefryKey key = threefry_key(k0, k1);
  const double w0 = 1.0 / (double)count;  // MC weights are uniform 1/S
  const double dn = (double)n;
  double acc_succ = 0.0, acc_all = 0.0;
  const long long step = (long long)g.nblk * blockDim.x;
  for (long long k = (long long)g.b * blockDim.x + threadIdx.x; k < count; k += step) {
    const uint32_t x0 = (uint32_t)k + key.k0;
    const double w = w0;
    McState st{0.0, 0.0, 0.0, 0};
    int pos = 0;
    for (; pos + 1 < n; pos += 2) {  // two independent blocks in flight
      const uint4 ra = mc_load<kShared>(recs + pos), rb = mc_load<kShared>(recs + pos + 1);
      const uint32_t ba = threefry2x32_x(key, x0, ra.x, one);
      const uint32_t bb = threefry2x32_x(key, x0, rb.x, one);
      mc_serve<kS, kShared>(st, ra, sizes, extra, pos, m, n_extra, slots, ba);
      mc_serve<kS, kShared>(st, rb, sizes, extra, pos + 1, m, n_extra, slots, bb);
    }
    if (pos < n) {
      const uint4 ra = mc_load<kShared>(recs + pos);
      mc_serve<kS, kShared>(st, ra, sizes, extra, pos, m, n_extra, slots,
                            threefry2x32_x(key, x0, ra.x, one));
    }
    // Eq. (7): mean sojourn of the successful jobs (0 when none);
    // Eq. (9): the weighted sum over samples.
    acc_succ += w * (st.cnt > 0 ? st.tot / (double)st.cnt : 0.0);
    acc_all += w * (st.tsum / dn);
  }
  write_partial(partials, g, acc_succ, acc_all);
}

// ---------------------------------------------------------------------------
// Explicit outcome tables (sojourn_outcomes)
// ---------------------------------------------------------------------------
//
// What bounds it: bytes at one order, the (K, N) int32 table and the (K,)
// float64 weights read once (193 MB at N = 21, K = 2^21: 0.058 ms at 3.35
// TB/s); at many orders the shared loads and the float64 issue of each row
// and order (phase 4 evaluates 17 orders at N = 27: about 90 float64
// instructions a row and order, 2N + 1 adds a success and the tail's two
// IEEE divisions).  The TPU kernel streamed the table once per order (its
// grid is (P, KT)), and this port's first kernel a job-major copy once per
// 8 orders, which its caller's order batches made once per order on the
// main path.  So this kernel reads each row tile once for a whole group of
// orders:
//
// * a persistent grid (nblk blocks, fixed for a shape) walks tiles of R
//   rows in the evaluator's own (K, N) layout: R N int32 are contiguous
//   bytes, brought in by one 1-d bulk copy (with the tile's weights) into
//   a ring of `stages` buffers on mbarriers, issued `stages` tiles ahead.
//   Plain loads take a ragged last tile and a table or weights not 16-byte
//   aligned;
// * each tile is transposed once into a padded (N, R + 2) 16-bit layout
//   of stop stages times 8, the byte offset of the stage's size in a row
//   of the sizes.  Row-major, a warp's threads, a row each, would read
//   words r N + j: gcd(N, 32)-way bank conflicts.  Transposed, thread t owns
//   rows 2t and 2t + 1 and reads both offsets of job j with one 32-bit load,
//   and a warp reads consecutive words;
// * the group's permuted sizes, stage counts and job columns sit in shared
//   memory.  The block's threads are `split` sets of R / 2, set q taking the
//   orders q, q + split, ... of the group for every row pair, so that more
//   warps share one tile.  A thread evaluates its orders for its two rows
//   (two chains), its shared loads four positions at a time (the jobs, then
//   the stop stages, then the sizes: each depends on the one before) ahead
//   of their adds.  A warp adds its rows' values with shuffles, in a fixed
//   tree, into its own slot of the order; the slots are added in a fixed
//   order at the end.  No atomics.
//
// Each (row, order) value keeps the first kernel's bits for finite sizes:
// completion times added in service order, a success's added as fma(1, t,
// tot) (the rounding of tot + t; fma(0, t, tot) = tot otherwise, without
// the select of a branch) and counted in a double, w * (tot / cnt) and w *
// (tsum / N), IEEE divisions.  Only the order of the sum over rows changes.  The wrapper
// (kernel.outcomes_plan) picks R from N, and the group size from N, M and
// the ring's bytes; where even 64 rows do not fit, or M passes 2^13 (a byte
// offset past 16 bits), outcomes_direct_kernel reads everything through L1.  Outcomes must lie
// in [0, M_i): the caller checks.
constexpr int kOutRowsPerThread = 2;

// Shared-memory layout of outcomes_kernel; the same bytes as
// kernel.outcomes_smem_bytes.
struct OutLayout {
  size_t ring, stage_tab, stage, w, sizes, acc, meta, col, total;
  int pitch;  // 32-bit words of a job's column of the transposed tile
  __host__ __device__ OutLayout(int n, int m, int rows, int stages, int groups, int split) {
    auto up16 = [](size_t b) { return (b + 15) & ~(size_t)15; };
    const int warps = rows / kOutRowsPerThread / 32 * split;
    pitch = rows / 2 + 1;
    stage_tab = (size_t)rows * n * sizeof(int);
    stage = stage_tab + (size_t)rows * sizeof(double);
    ring = 32;  // the stages' mbarriers, up to four
    w = ring + stages * stage;
    sizes = w + (size_t)rows * sizeof(double);
    acc = sizes + (size_t)groups * n * m * sizeof(double);
    meta = acc + (size_t)groups * warps * 2 * sizeof(double);
    col = up16(meta + (size_t)groups * n * sizeof(int2));
    total = up16(col + (size_t)n * pitch * sizeof(uint32_t));
  }
};

// Tile rows (valid of them real) from `tab` (R, N) and `wts` (R,) into the
// transposed 16-bit tile (stage x 8) and the weights; rows past `valid`
// become stage 0 with weight 0.  Four loads in flight a thread before their
// stores.
__device__ __forceinline__ void out_transpose(const int* tab, const double* wts, int rows, int n,
                                              int valid, int pitch16, uint16_t* col,
                                              double* w) {
  const int tid = threadIdx.x, threads = blockDim.x, total = rows * n;
  const int dr = threads / n, dj = threads % n;
  int r = tid / n, j = tid % n, i = tid;
  for (; i + 3 * threads < total; i += 4 * threads) {
    int v[4], at[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      v[u] = r < valid ? tab[i + u * threads] * (int)sizeof(double) : 0;
      at[u] = j * pitch16 + r;
      r += dr;
      j += dj;
      if (j >= n) {
        j -= n;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) col[at[u]] = (uint16_t)v[u];
  }
  for (; i < total; i += threads) {
    col[j * pitch16 + r] = (uint16_t)(r < valid ? tab[i] * (int)sizeof(double) : 0);
    r += dr;
    j += dj;
    if (j >= n) {
      j -= n;
      ++r;
    }
  }
  for (int k = tid; k < rows; k += threads) w[k] = k < valid ? wts[k] : 0.0;
}

__global__ void __launch_bounds__(256, 2) outcomes_kernel(
    const double* __restrict__ sizes_p,  // (G, N, M) permuted cumulative sizes
    const int* __restrict__ radix_p,     // (G, N) permuted stage counts
    const int* __restrict__ orders,      // (G, N) original job id by position
    const int* __restrict__ outcomes,    // (K, N) stop stages, row-major
    const double* __restrict__ weights,  // (K,) combination weights
    int n_orders, int n, int m, long long k_total, int rows, int stages, int split,
    double* __restrict__ partials) {     // (G, nblk, 2)
  extern __shared__ __align__(16) unsigned char out_smem[];
  const OutLayout lay(n, m, rows, stages, n_orders, split);
  const int tid = threadIdx.x, threads = blockDim.x;
  const int warps = threads / 32, warp = tid / 32, lane = tid % 32;
  const int half = rows / kOutRowsPerThread;
  const int pr = tid % half, set = tid / half;  // row pair 2 pr, 2 pr + 1; order set
  uint64_t* bars = reinterpret_cast<uint64_t*>(out_smem);
  double* s_w = reinterpret_cast<double*>(out_smem + lay.w);
  double* s_sizes = reinterpret_cast<double*>(out_smem + lay.sizes);
  double* s_acc = reinterpret_cast<double*>(out_smem + lay.acc);
  int2* s_meta = reinterpret_cast<int2*>(out_smem + lay.meta);
  uint32_t* s_col = reinterpret_cast<uint32_t*>(out_smem + lay.col);

  for (int i = tid; i < n_orders * n * m; i += threads) s_sizes[i] = sizes_p[i];
  for (int i = tid; i < n_orders * n; i += threads)
    s_meta[i] = make_int2(orders[i] * lay.pitch, (radix_p[i] - 1) * (int)sizeof(double));
  for (int i = tid; i < n_orders * warps * 2; i += threads) s_acc[i] = 0.0;

  const long long n_tiles = (k_total + rows - 1) / rows;
  const bool aligned = !(reinterpret_cast<uintptr_t>(outcomes) & 15) &&
                       !(reinterpret_cast<uintptr_t>(weights) & 15);
  auto bulk = [&](long long tile) { return aligned && (tile + 1) * rows <= k_total; };
  auto stage_at = [&](int s) { return out_smem + lay.ring + s * lay.stage; };
  auto issue = [&](long long tile, int s) {  // one thread
    const uint32_t bar = hopper::smem_u32(bars + s);
    const uint32_t tab_bytes = (uint32_t)lay.stage_tab, w_bytes = rows * sizeof(double);
    hopper::mbar_expect_tx(bar, tab_bytes + w_bytes);
    hopper::bulk_load(hopper::smem_u32(stage_at(s)), outcomes + tile * rows * n, tab_bytes, bar);
    hopper::bulk_load(hopper::smem_u32(stage_at(s) + tab_bytes), weights + tile * rows, w_bytes,
                      bar);
  };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) hopper::mbar_init(hopper::smem_u32(bars + s), 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      const long long tile = blockIdx.x + (long long)s * gridDim.x;
      if (tile < n_tiles && bulk(tile)) issue(tile, s);
    }
  }

  uint16_t* col16 = reinterpret_cast<uint16_t*>(s_col);
  const double dn = (double)n;
  int i_local = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i_local) {
    const int s = i_local % stages;
    const int valid = (int)min((long long)rows, k_total - tile * rows);
    if (bulk(tile)) {
      hopper::mbar_wait(hopper::smem_u32(bars + s), (i_local / stages) & 1);
      out_transpose(reinterpret_cast<const int*>(stage_at(s)),
                    reinterpret_cast<const double*>(stage_at(s) + lay.stage_tab), rows, n,
                    valid, 2 * lay.pitch, col16, s_w);
    } else {  // plain loads, straight from device memory
      out_transpose(outcomes + tile * rows * n, weights + tile * rows, rows, n, valid,
                    2 * lay.pitch, col16, s_w);
    }
    __syncthreads();  // the stage is free and the transposed tile complete
    if (tid == 0) {
      const long long next = tile + (long long)stages * gridDim.x;
      if (next < n_tiles && bulk(next)) issue(next, s);
    }

    const double2 w2 = reinterpret_cast<const double2*>(s_w)[pr];
    const bool oka = 2 * pr < valid, okb = 2 * pr + 1 < valid;
    const uint32_t* my_col = s_col + pr;
    for (int o = set; o < n_orders; o += split) {
      const int2* meta = s_meta + o * n;  // {column's word, (r - 1) x 8}
      const unsigned char* sz =
          reinterpret_cast<const unsigned char*>(s_sizes + (size_t)o * n * m);
      double ta = 0.0, tsa = 0.0, tta = 0.0, ca = 0.0, tb = 0.0, tsb = 0.0, ttb = 0.0, cb = 0.0;
      // serve position `pos` of both rows, given their stages' byte offsets
      auto serve = [&](int2 mt, uint32_t pair, double za, double zb) {
        ta += za;  // completion time of the pos-th served job
        tsa += ta;
        const double fa = (int)(pair & 0xFFFFu) == mt.y ? 1.0 : 0.0;  // a success
        tta = fma(fa, ta, tta);
        ca += fa;
        tb += zb;
        tsb += tb;
        const double fb = (int)(pair >> 16) == mt.y ? 1.0 : 0.0;
        ttb = fma(fb, tb, ttb);
        cb += fb;
      };
      auto size_at = [&](int pos, uint32_t offset) {
        return *reinterpret_cast<const double*>(sz + (size_t)pos * m * sizeof(double) + offset);
      };
      int pos = 0;
      for (; pos + 4 <= n; pos += 4) {
        int2 mt[4];
        uint32_t pair[4];
        double za[4], zb[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) mt[u] = meta[pos + u];
#pragma unroll
        for (int u = 0; u < 4; ++u) pair[u] = my_col[mt[u].x];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          za[u] = size_at(pos + u, pair[u] & 0xFFFFu);
          zb[u] = size_at(pos + u, pair[u] >> 16);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) serve(mt[u], pair[u], za[u], zb[u]);
      }
      for (; pos < n; ++pos) {
        const int2 mt = meta[pos];
        const uint32_t pair = my_col[mt.x];
        serve(mt, pair, size_at(pos, pair & 0xFFFFu), size_at(pos, pair >> 16));
      }
      double vs = (oka ? w2.x * (ca > 0.0 ? tta / ca : 0.0) : 0.0) +
                  (okb ? w2.y * (cb > 0.0 ? ttb / cb : 0.0) : 0.0);
      double va = (oka ? w2.x * (tsa / dn) : 0.0) + (okb ? w2.y * (tsb / dn) : 0.0);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        vs += __shfl_down_sync(0xffffffffu, vs, off);
        va += __shfl_down_sync(0xffffffffu, va, off);
      }
      if (lane == 0) {
        s_acc[(o * warps + warp) * 2] += vs;
        s_acc[(o * warps + warp) * 2 + 1] += va;
      }
    }
    __syncthreads();  // the transposed tile is free
  }
  for (int o = tid; o < n_orders; o += threads) {
    double a = 0.0, b = 0.0;
    for (int w = 0; w < warps; ++w) {
      a += s_acc[(o * warps + w) * 2];
      b += s_acc[(o * warps + w) * 2 + 1];
    }
    const size_t at = ((size_t)o * gridDim.x + blockIdx.x) * 2;
    partials[at] = a;
    partials[at + 1] = b;
  }
}

// The same values where even 64 rows of the table do not fit shared memory
// (N of several hundred): a thread a row, everything read through L1, one
// order a grid row.
__global__ void __launch_bounds__(kThreads) outcomes_direct_kernel(
    const double* __restrict__ sizes_p, const int* __restrict__ radix_p,
    const int* __restrict__ orders, const int* __restrict__ outcomes,
    const double* __restrict__ weights, int n, int m, long long k_total, int orders_on_x,
    double* __restrict__ partials) {
  const GridPos g = grid_pos(orders_on_x);
  const double* sz = sizes_p + (size_t)g.p * n * m;
  const int* ord = orders + (size_t)g.p * n;
  const int* rad = radix_p + (size_t)g.p * n;
  const double dn = (double)n;
  double acc_succ = 0.0, acc_all = 0.0;
  const long long step = (long long)g.nblk * blockDim.x;
  for (long long k = (long long)g.b * blockDim.x + threadIdx.x; k < k_total; k += step) {
    const int* row = outcomes + k * n;
    double t = 0.0, tsum = 0.0, tot = 0.0;
    int cnt = 0;
    for (int pos = 0; pos < n; ++pos) {
      const int s = __ldg(row + __ldg(ord + pos));
      t += __ldg(sz + pos * m + s);
      tsum += t;
      if (s == __ldg(rad + pos) - 1) {
        tot += t;
        ++cnt;
      }
    }
    const double w = __ldg(weights + k);
    acc_succ += w * (cnt > 0 ? tot / (double)cnt : 0.0);
    acc_all += w * (tsum / dn);
  }
  write_partial(partials, g, acc_succ, acc_all);
}

}  // namespace sojourn

// Exact Eqs. (7)-(9) for P static orders over all their combinations, the
// last `suffix` service positions walked by each thread (0..kMaxSuffix,
// at most n).  out (2, P): E[sojourn | successful], E[sojourn | all]; NaN
// for an order whose strides_p are not its radix_p's mixed-radix strides in
// some job order or whose radix_p's product is not k_total.
extern "C" int sojourn_enum_launch(const double* sizes_p, const double* probs_p,
                                   const int* strides_p, const int* radix_p, int n_orders,
                                   int n, int m, long long k_total, int suffix, int nblk,
                                   double* partials, double* out, void* stream) {
  using namespace sojourn;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SOJOURN_ENUM_CASE(L) \
  case L:                    \
    return launch_enum<L>(sizes_p, probs_p, strides_p, radix_p, n_orders, n, m, k_total, nblk, \
                          partials, out, st);
  static_assert(kMaxSuffix == 8, "the cases below instantiate suffixes 0 to 8");
  if (suffix > n) return (int)cudaErrorInvalidValue;
  switch (suffix) {
    SOJOURN_ENUM_CASE(0)
    SOJOURN_ENUM_CASE(1)
    SOJOURN_ENUM_CASE(2)
    SOJOURN_ENUM_CASE(3)
    SOJOURN_ENUM_CASE(4)
    SOJOURN_ENUM_CASE(5)
    SOJOURN_ENUM_CASE(6)
    SOJOURN_ENUM_CASE(7)
    SOJOURN_ENUM_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SOJOURN_ENUM_CASE
}

// Shared-memory bytes a block may opt into on this card.
static int smem_optin_max() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

template <int kS, bool kShared>
static int launch_mc(const double* sizes_p, const void* recs, const void* extra, int n_orders,
                     int n, int m, long long n_samples, unsigned int k0, unsigned int k1,
                     int nblk, size_t smem, double* partials, double* out, cudaStream_t st) {
  using namespace sojourn;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mc_kernel<kS, kShared>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int orders_on_x;
  const dim3 grid = make_grid(n_orders, nblk, &orders_on_x);
  mc_kernel<kS, kShared><<<grid, kThreads, smem, st>>>(
      sizes_p, static_cast<const uint4*>(recs), static_cast<const uint32_t*>(extra), n, m,
      n_samples, k0, k1, 1u, orders_on_x, partials);
  return finish_launch(partials, nblk, n_orders, out, st);
}

// Streamed Monte Carlo over S samples under the key (k0, k1), from the
// position records recs (P, N, 4) and further thresholds extra (P, N, M - 2)
// that kernel.mc_tables makes.  The tables sit in shared memory where they
// fit the card's limit and are read through L1 past it.
extern "C" int sojourn_mc_launch(const double* sizes_p, const void* recs, const void* extra,
                                 int n_orders, int n, int m, long long n_samples,
                                 unsigned int k0, unsigned int k1, int nblk,
                                 double* partials, double* out, void* stream) {
  using namespace sojourn;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)n * 16 + (size_t)n * m * sizeof(double) +
                      (size_t)n * (m > 2 ? m - 2 : 0) * sizeof(uint32_t);
  const bool shared = smem + 1024 <= (size_t)smem_optin_max();  // and block_sum2's slots
  const int slots = m > 1 ? m - 1 : 1;
#define SOJOURN_MC_CASE(S)                                                                   \
  if (slots == S || S == 0) {                                                                \
    return shared ? launch_mc<S, true>(sizes_p, recs, extra, n_orders, n, m, n_samples, k0, \
                                       k1, nblk, smem, partials, out, st)                   \
                  : launch_mc<S, false>(sizes_p, recs, extra, n_orders, n, m, n_samples, k0, \
                                        k1, nblk, 0, partials, out, st);                    \
  }
  SOJOURN_MC_CASE(1)
  SOJOURN_MC_CASE(2)
  SOJOURN_MC_CASE(3)
  SOJOURN_MC_CASE(0)
#undef SOJOURN_MC_CASE
  return (int)cudaErrorInvalidValue;
}

// Shared-memory bytes of outcomes_kernel (the wrapper's plan checks the
// same count).
extern "C" long long sojourn_outcomes_smem(int n, int m, int rows, int stages, int n_orders,
                                           int split) {
  return (long long)sojourn::OutLayout(n, m, rows, stages, n_orders, split).total;
}

// Eqs. (7)-(9) of P static orders over an explicit (K, N) row-major
// outcome table with weights (K,), every order against one read of each
// row tile: `rows` rows a tile (64, 128 or 256; M at most 2^13), `split`
// sets of rows / 2 threads a block (at most 256 threads) sharing out the
// orders, `stages` tiles in flight, nblk persistent blocks.  rows = 0 takes
// outcomes_direct_kernel (nblk blocks an order) instead.
extern "C" int sojourn_outcomes_launch(const double* sizes_p, const int* radix_p,
                                       const int* orders, const int* outcomes,
                                       const double* weights, int n_orders, int n,
                                       int m, long long k_total, int rows, int stages,
                                       int split, int nblk, double* partials, double* out,
                                       void* stream) {
  using namespace sojourn;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 0) {
    int orders_on_x;
    const dim3 grid = make_grid(n_orders, nblk, &orders_on_x);
    outcomes_direct_kernel<<<grid, kThreads, 0, st>>>(sizes_p, radix_p, orders, outcomes,
                                                      weights, n, m, k_total, orders_on_x,
                                                      partials);
    return finish_launch(partials, nblk, n_orders, out, st);
  }
  const int threads = rows / kOutRowsPerThread * split;
  if (rows % 64 || rows > 256 || stages < 1 || stages > 4 || m > 8192 || split < 1 ||
      threads > 256)
    return (int)cudaErrorInvalidValue;  // the transposed tile holds 16-bit byte offsets
  const size_t smem = OutLayout(n, m, rows, stages, n_orders, split).total;
  if (smem > (size_t)smem_optin_max()) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        outcomes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  outcomes_kernel<<<nblk, threads, smem, st>>>(sizes_p, radix_p, orders, outcomes, weights,
                                               n_orders, n, m, k_total, rows, stages, split,
                                               partials);
  return finish_launch(partials, nblk, n_orders, out, st);
}
