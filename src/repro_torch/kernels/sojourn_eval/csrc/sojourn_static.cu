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
// x1 = ORIGINAL job id) followed by an inverse-CDF count over the CDF
// computed on the host.  What bounds it: about (M + 3) N float64
// operations plus 20 Threefry rounds of uint32 arithmetic a job and
// sample.  So a block reads the order's permuted (N, M) tables once into
// shared memory (kilobytes) and writes two doubles, and every thread takes
// a grid-stride walk over its order's samples.
__global__ void __launch_bounds__(kThreads) mc_kernel(
    const double* __restrict__ sizes_p,  // (P, N, M) permuted cumulative sizes
    const double* __restrict__ cdf_p,    // (P, N, M) permuted CDF
    const int* __restrict__ orders,      // (P, N) original job ids by position
    const int* __restrict__ radix_p,     // (P, N) permuted stage counts
    int n, int m, long long count, uint32_t k0, uint32_t k1, int orders_on_x,
    double* __restrict__ partials) {     // (P, nblk, 2)
  extern __shared__ double smem[];
  double* s_sizes = smem;
  double* s_tab = smem + n * m;
  int* s_aux = reinterpret_cast<int*>(smem + 2 * n * m);
  int* s_radix = s_aux + n;

  const GridPos g = grid_pos(orders_on_x);
  const size_t tab_off = (size_t)g.p * n * m;
  for (int i = threadIdx.x; i < n * m; i += blockDim.x) {
    s_sizes[i] = sizes_p[tab_off + i];
    s_tab[i] = cdf_p[tab_off + i];
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s_aux[i] = orders[(size_t)g.p * n + i];
    s_radix[i] = radix_p[(size_t)g.p * n + i];
  }
  __syncthreads();

  const double w0 = 1.0 / (double)count;  // MC weights are uniform 1/S
  const double dn = (double)n;
  double acc_succ = 0.0, acc_all = 0.0;
  const long long step = (long long)g.nblk * blockDim.x;
  for (long long k = (long long)g.b * blockDim.x + threadIdx.x; k < count;
       k += step) {
    double w = w0, t = 0.0, tsum = 0.0, tot = 0.0;
    int cnt = 0;
    for (int pos = 0; pos < n; ++pos) {
      const int r = s_radix[pos];
      const double* tab = s_tab + pos * m;
      const double u = uniform_from_bits(
          threefry2x32(k0, k1, (uint32_t)k, (uint32_t)s_aux[pos]).x);
      int c = 0;
      for (int j = 0; j < m; ++j) c += (u >= tab[j]);
      const int s = min(c, r - 1);
      t += s_sizes[pos * m + s];
      tsum += t;
      if (s == r - 1) {  // success: stopped at the last stage
        tot += t;
        ++cnt;
      }
    }
    // Eq. (7): mean sojourn of the successful jobs (0 when none);
    // Eq. (9): the weighted sum over samples.
    acc_succ += w * (cnt > 0 ? tot / (double)cnt : 0.0);
    acc_all += w * (tsum / dn);
  }
  write_partial(partials, g, acc_succ, acc_all);
}

// Explicit outcome tables (sojourn_outcomes).
//
// What bounds it: bytes.  The (N, K) int32 table and the (K,) float64
// weights are read from device memory (176 MB + 16.8 MB at N = 21,
// K = 2^21: ~58 us at 3.35 TB/s), while a lane does only ~4N float64
// operations.  So a block reads each table column once and evaluates up
// to kOutChunk orders against it: the table is job-major (outcomes_t[j, k])
// so that neighbouring threads read neighbouring k, each thread copies its
// own column into shared memory (no block barrier: a thread reads back
// only what it wrote) and gathers it there in each order's service
// order.  The TPU kernel streams the table once per order instead (its
// grid is (P, KT)).  Outcomes must lie in [0, M_i): the caller checks.
constexpr int kOutChunk = 8;  // orders evaluated against one read of a column

__global__ void __launch_bounds__(kThreads) outcomes_kernel(
    const double* __restrict__ sizes_p,  // (P, N, M) permuted cumulative sizes
    const int* __restrict__ radix_p,     // (P, N) permuted stage counts
    const int* __restrict__ orders,      // (P, N) original job id by position
    const int* __restrict__ outcomes_t,  // (N, K) stop stages, job-major
    const double* __restrict__ weights,  // (K,) combination weights
    int n_orders, int n, int m, long long k_total,
    double* __restrict__ partials) {     // (P, nblk, 2)
  extern __shared__ double smem[];
  double* s_sizes = smem;                                         // (C, N, M)
  int* s_ord = reinterpret_cast<int*>(smem + kOutChunk * n * m);  // (C, N)
  int* s_radix = s_ord + kOutChunk * n;                           // (C, N)
  int* s_col = s_radix + kOutChunk * n;                           // (N, kThreads)

  const int p0 = blockIdx.y * kOutChunk;
  const int nc = min(kOutChunk, n_orders - p0);
  for (int i = threadIdx.x; i < nc * n * m; i += blockDim.x)
    s_sizes[i] = sizes_p[(size_t)p0 * n * m + i];
  for (int i = threadIdx.x; i < nc * n; i += blockDim.x) {
    s_ord[i] = orders[(size_t)p0 * n + i];
    s_radix[i] = radix_p[(size_t)p0 * n + i];
  }
  __syncthreads();

  double acc_succ[kOutChunk], acc_all[kOutChunk];
#pragma unroll
  for (int c = 0; c < kOutChunk; ++c) acc_succ[c] = acc_all[c] = 0.0;
  const double dn = (double)n;
  int* col = s_col + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       k < k_total; k += step) {
    for (int j = 0; j < n; ++j) col[j * kThreads] = outcomes_t[(size_t)j * k_total + k];
    const double w = weights[k];
#pragma unroll
    for (int c = 0; c < kOutChunk; ++c) {
      if (c >= nc) continue;
      const int* ord = s_ord + c * n;
      const int* rad = s_radix + c * n;
      const double* sz = s_sizes + c * n * m;
      double t = 0.0, tsum = 0.0, tot = 0.0;
      int cnt = 0;
      for (int pos = 0; pos < n; ++pos) {
        const int s = col[ord[pos] * kThreads];
        t += sz[pos * m + s];  // completion time of the pos-th served job
        tsum += t;
        if (s == rad[pos] - 1) {  // success: stopped at the last stage
          tot += t;
          ++cnt;
        }
      }
      acc_succ[c] += w * (cnt > 0 ? tot / (double)cnt : 0.0);
      acc_all[c] += w * (tsum / dn);
    }
  }
#pragma unroll
  for (int c = 0; c < kOutChunk; ++c) {
    if (c >= nc) continue;  // nc is the same for the whole block
    const GridPos g{p0 + c, (int)blockIdx.x, (int)gridDim.x};
    write_partial(partials, g, acc_succ[c], acc_all[c]);
    __syncthreads();  // block_sum2's shared slots are reused by the next order
  }
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

// Streamed Monte Carlo over S samples under the key (k0, k1).
extern "C" int sojourn_mc_launch(const double* sizes_p, const double* cdf_p,
                                 const int* orders, const int* radix_p,
                                 int n_orders, int n, int m, long long n_samples,
                                 unsigned int k0, unsigned int k1, int nblk,
                                 double* partials, double* out, void* stream) {
  using namespace sojourn;
  int orders_on_x;
  const dim3 grid = make_grid(n_orders, nblk, &orders_on_x);
  const size_t smem = 2 * (size_t)n * m * sizeof(double) + 2 * (size_t)n * sizeof(int);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  mc_kernel<<<grid, kThreads, smem, st>>>(sizes_p, cdf_p, orders, radix_p, n, m, n_samples,
                                          k0, k1, orders_on_x, partials);
  return finish_launch(partials, nblk, n_orders, out, st);
}

// Eqs. (7)-(9) of P static orders over an explicit (K, N) outcome table,
// given job-major as outcomes_t (N, K), with weights (K,).  nblk blocks
// walk K for each chunk of kOutChunk orders.
extern "C" int sojourn_outcomes_launch(const double* sizes_p, const int* radix_p,
                                       const int* orders, const int* outcomes_t,
                                       const double* weights, int n_orders, int n,
                                       int m, long long k_total, int nblk,
                                       double* partials, double* out,
                                       void* stream) {
  using namespace sojourn;
  const int chunks = (n_orders + kOutChunk - 1) / kOutChunk;
  const size_t smem = (size_t)kOutChunk * n * m * sizeof(double) +
                      2 * (size_t)kOutChunk * n * sizeof(int) +
                      (size_t)n * kThreads * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        outcomes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  outcomes_kernel<<<dim3(nblk, chunks), kThreads, smem, st>>>(
      sizes_p, radix_p, orders, outcomes_t, weights, n_orders, n, m, k_total,
      partials);
  return finish_launch(partials, nblk, n_orders, out, st);
}
