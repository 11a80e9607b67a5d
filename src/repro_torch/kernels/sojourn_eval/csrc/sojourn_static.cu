// Fused E[sojourn] of static orders: exact enumeration, streamed MC and
// explicit outcome tables.
//
// Replaces the TPU kernels of repro/kernels/sojourn_eval/kernel.py:
//   sojourn_enum     (_enum_kernel)     -> sojourn_enum_launch
//   sojourn_mc       (_mc_kernel)       -> sojourn_mc_launch
//   sojourn_outcomes (_outcomes_kernel) -> sojourn_outcomes_launch
// One __global__ serves both, templated on how a lane decodes its
// outcome combination: the mixed-radix rule (k / stride) % M, or the
// Threefry stream (seed; x0 = sample, x1 = ORIGINAL job id) followed by
// an inverse-CDF count over the CDF computed on the host.
//
// What bounds it: float64 operations.  A block reads the order's
// permuted (N, M) tables once into shared memory (kilobytes) and writes
// two doubles; each lane then does ~3N float64 operations per
// combination (enum) or ~(M + 3)N plus 20 Threefry rounds of uint32
// arithmetic per sample (MC).  So the design keeps everything in shared
// memory and registers, gives every thread a grid-stride walk over its
// order's indices, and reduces without atomics (common.cuh).
//
// Inputs are pre-permuted by the caller: position pos of order p reads
// tables[p, pos, :], so the running sum t after pos steps is the
// completion time of the job served pos-th.  Everything is float64, as
// the JAX package computes under x64.
#include "common.cuh"
#include "threefry.cuh"

namespace sojourn {

template <bool kMC>
__global__ void __launch_bounds__(kThreads) static_kernel(
    const double* __restrict__ sizes_p,  // (P, N, M) permuted cumulative sizes
    const double* __restrict__ tab_p,    // (P, N, M) stop probs (enum) / CDF (MC)
    const int* __restrict__ aux_p,       // (P, N) strides (enum) / job ids (MC)
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
    s_tab[i] = tab_p[tab_off + i];
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s_aux[i] = aux_p[(size_t)g.p * n + i];
    s_radix[i] = radix_p[(size_t)g.p * n + i];
  }
  __syncthreads();

  // MC weights are uniform 1/S; enumeration weights are Eq. (8)'s product.
  const double w0 = kMC ? 1.0 / (double)count : 1.0;
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
      int s;
      if constexpr (kMC) {
        const double u = uniform_from_bits(
            threefry2x32(k0, k1, (uint32_t)k, (uint32_t)s_aux[pos]).x);
        int c = 0;
        for (int j = 0; j < m; ++j) c += (u >= tab[j]);
        s = min(c, r - 1);
      } else {
        s = (int)(((uint32_t)k / (uint32_t)s_aux[pos]) % (uint32_t)r);
        w *= tab[s];
      }
      t += s_sizes[pos * m + s];
      tsum += t;
      if (s == r - 1) {  // success: stopped at the last stage
        tot += t;
        ++cnt;
      }
    }
    // Eq. (7): mean sojourn of the successful jobs (0 when none);
    // Eq. (9): the weighted sum over combinations.
    acc_succ += w * (cnt > 0 ? tot / (double)cnt : 0.0);
    acc_all += w * (tsum / dn);
  }
  write_partial(partials, g, acc_succ, acc_all);
}

template <bool kMC>
int launch_static(const double* sizes_p, const double* tab_p, const int* aux_p,
                  const int* radix_p, int n_orders, int n, int m,
                  long long count, uint32_t k0, uint32_t k1, int nblk,
                  double* partials, double* out, void* stream) {
  int orders_on_x;
  const dim3 grid = make_grid(n_orders, nblk, &orders_on_x);
  const size_t smem = 2 * (size_t)n * m * sizeof(double) + 2 * (size_t)n * sizeof(int);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static_kernel<kMC><<<grid, kThreads, smem, st>>>(
      sizes_p, tab_p, aux_p, radix_p, n, m, count, k0, k1, orders_on_x, partials);
  return finish_launch(partials, nblk, n_orders, out, st);
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

// Exact Eqs. (7)-(9) for P static orders over K combinations.
// out (2, P): E[sojourn | successful], E[sojourn | all].
extern "C" int sojourn_enum_launch(const double* sizes_p, const double* probs_p,
                                   const int* strides_p, const int* radix_p,
                                   int n_orders, int n, int m, long long k_total,
                                   int nblk, double* partials, double* out,
                                   void* stream) {
  return sojourn::launch_static<false>(sizes_p, probs_p, strides_p, radix_p,
                                       n_orders, n, m, k_total, 0u, 0u, nblk,
                                       partials, out, stream);
}

// Streamed Monte Carlo over S samples under the key (k0, k1).
extern "C" int sojourn_mc_launch(const double* sizes_p, const double* cdf_p,
                                 const int* orders, const int* radix_p,
                                 int n_orders, int n, int m, long long n_samples,
                                 unsigned int k0, unsigned int k1, int nblk,
                                 double* partials, double* out, void* stream) {
  return sojourn::launch_static<true>(sizes_p, cdf_p, orders, radix_p, n_orders,
                                      n, m, n_samples, k0, k1, nblk, partials,
                                      out, stream);
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
