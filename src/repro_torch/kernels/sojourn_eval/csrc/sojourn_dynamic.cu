// Fused E[sojourn] of stage-level index policies on W servers.
//
// Replaces the TPU kernels of repro/kernels/sojourn_eval/dynamic.py:
//   dynamic_sojourn_enum (_dynamic_kernel + _lockstep_sim) -> dynamic_enum_launch
//   dynamic_sojourn_mc   (_dynamic_mc_kernel + _lockstep_sim) -> dynamic_mc_launch
// One __global__ serves both, templated on the decoder (mixed radix, or
// the Threefry stream with x1 = job id j) and on NMAX, the register
// capacity for jobs (8, 16, 32 or 64; the launch picks the smallest
// that holds N; larger groups take dynamic_kernel_large, below).
//
// Each thread owns one combination (or sample) at a time and runs the
// lockstep simulation of _lockstep_sim exactly:
//   * seat min(W, N) jobs at t = 0, one dispatch pass each;
//   * then total_stages steps of (pop the earliest busy_until, one
//     dispatch pass);
//   * both minimum searches use a strict < in job order, sentinel n, so
//     ties go to the lowest job position and a +inf index never wins;
//   * a job is queued when busy == +inf and stage <= its stop stage.
// The per-job state (stage, busy_until, stop stage) lives in registers:
// every loop over jobs is unrolled to NMAX with compile-time indices, and
// padding jobs (j >= n) carry stop stage -1, so they are never queued.
// The policy's index table and the stage durations sit in shared memory.
//
// What bounds it: float64 operations (compares in both minimum searches,
// the clock adds), about 3N per simulated step and sum(M_i) steps per
// combination; its tables are kilobytes.  Reduction as in common.cuh.
//
// Past 64 jobs (dynamic_kernel_large) registers cannot hold the state:
// NMAX = 32 already takes 196 of them.  There each thread keeps its jobs'
// state in device scratch that the wrapper allocates, 16 bytes a job:
// (stage, stop stage) as an int2 and busy_until as a double.  Shared
// memory would cap N again (16 N bytes a thread: 64 threads at N = 200
// fill a block's 227 KB), so the scratch lives in global memory, job-major
// (job j of thread t at j * T + t for T threads in the grid): the threads
// of a warp touch 32 neighbouring words at each step of a loop over jobs.
// The grid is cut to 4 blocks an SM (kernel.py's SCRATCH_BLOCKS), whose
// threads walk the index range, so the scratch is T x N x 16 bytes for
// T = 135,168 at most.  N is a run-time argument and the loops over jobs
// are not unrolled; the tables are read through the read-only cache.
// The simulation is the register path's, step for step: the same strict <
// searches with sentinel n, so ties go to the lowest job and a +inf index
// is never seated.
#include "common.cuh"
#include "threefry.cuh"

namespace sojourn {

constexpr int kRegisterJobs = 64;  // the largest NMAX; larger groups take the scratch path

template <int NMAX>
__device__ __forceinline__ void dispatch_one(const int (&stage)[NMAX],
                                             double (&busy)[NMAX],
                                             const int (&sdec)[NMAX],
                                             const double* s_idx,
                                             const double* s_dur, int n, int m,
                                             int w_srv, int& nbusy,
                                             double clock) {
  double best = CUDART_INF;
  int bestj = n;
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    if (busy[j] == CUDART_INF && stage[j] <= sdec[j]) {
      const double v = s_idx[j * m + stage[j]];
      if (v < best) {
        best = v;
        bestj = j;
      }
    }
  }
  if (nbusy < w_srv && bestj < n) {
#pragma unroll
    for (int j = 0; j < NMAX; ++j) {
      if (j == bestj) busy[j] = clock + s_dur[j * m + stage[j]];
    }
    ++nbusy;
  }
}

template <int NMAX, bool kMC>
__global__ void __launch_bounds__(kThreads) dynamic_kernel(
    const double* __restrict__ tab,         // (N, M) stop probs (enum) / CDF (MC)
    const double* __restrict__ durs,        // (N, M) per-stage service increments
    const double* __restrict__ idx_tables,  // (P, N, M) index tables (+inf pad)
    const int* __restrict__ strides,        // (N,) mixed-radix strides (enum only)
    const int* __restrict__ radix,          // (N,) stage counts
    int n, int m, long long count, uint32_t k0, uint32_t k1, int total_stages,
    int w_srv, int orders_on_x, double* __restrict__ partials) {
  extern __shared__ double smem[];
  double* s_tab = smem;
  double* s_dur = smem + n * m;
  double* s_idx = smem + 2 * n * m;
  int* s_stride = reinterpret_cast<int*>(smem + 3 * n * m);
  int* s_radix = s_stride + n;

  const GridPos g = grid_pos(orders_on_x);
  for (int i = threadIdx.x; i < n * m; i += blockDim.x) {
    s_tab[i] = tab[i];
    s_dur[i] = durs[i];
    s_idx[i] = idx_tables[(size_t)g.p * n * m + i];
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s_stride[i] = kMC ? 0 : strides[i];
    s_radix[i] = radix[i];
  }
  __syncthreads();

  const double w0 = kMC ? 1.0 / (double)count : 1.0;
  const double dn = (double)n;
  double acc_succ = 0.0, acc_all = 0.0;
  const long long step = (long long)g.nblk * blockDim.x;
  for (long long k = (long long)g.b * blockDim.x + threadIdx.x; k < count;
       k += step) {
    // --- decode: stop stage and success flag per job, Eq.-8 weight ---
    int sdec[NMAX], stage[NMAX];
    double busy[NMAX];
    unsigned long long succ = 0ull;
    double w = w0;
#pragma unroll
    for (int j = 0; j < NMAX; ++j) {
      stage[j] = 0;
      busy[j] = CUDART_INF;
      sdec[j] = -1;  // padding jobs are never queued
      if (j < n) {
        const int r = s_radix[j];
        int s;
        if constexpr (kMC) {
          const double u = uniform_from_bits(
              threefry2x32(k0, k1, (uint32_t)k, (uint32_t)j).x);
          int c = 0;
          for (int q = 0; q < m; ++q) c += (u >= s_tab[j * m + q]);
          s = min(c, r - 1);
        } else {
          s = (int)(((uint32_t)k / (uint32_t)s_stride[j]) % (uint32_t)r);
          w *= s_tab[j * m + s];
        }
        sdec[j] = s;
        if (s == r - 1) succ |= 1ull << j;
      }
    }

    // --- lockstep W-server simulation (stage-boundary preemption) ---
    int nbusy = 0;
    for (int i = 0; i < w_srv; ++i)  // t = 0: seat the W smallest indices
      dispatch_one<NMAX>(stage, busy, sdec, s_idx, s_dur, n, m, w_srv, nbusy, 0.0);
    double clock = 0.0, tot = 0.0, tsum = 0.0;
    int cnt = 0;
    for (int it = 0; it < total_stages; ++it) {
      // complete: pop the running job with the earliest finish time
      double tmin = CUDART_INF;
      int cjob = n;
#pragma unroll
      for (int j = 0; j < NMAX; ++j) {
        if (busy[j] < tmin) {
          tmin = busy[j];
          cjob = j;
        }
      }
      if (cjob < n) {
        clock = tmin;
        bool fin = false;
#pragma unroll
        for (int j = 0; j < NMAX; ++j) {
          if (j == cjob) {
            fin = stage[j] == sdec[j];
            stage[j] += 1;
            busy[j] = CUDART_INF;
          }
        }
        --nbusy;
        if (fin) {
          tsum += clock;
          if ((succ >> cjob) & 1ull) {
            tot += clock;
            ++cnt;
          }
        }
      }
      // refill the freed server: at most one job (re)joined the queue
      dispatch_one<NMAX>(stage, busy, sdec, s_idx, s_dur, n, m, w_srv, nbusy, clock);
    }
    acc_succ += w * (cnt > 0 ? tot / (double)cnt : 0.0);
    acc_all += w * (tsum / dn);
  }
  write_partial(partials, g, acc_succ, acc_all);
}

// One dispatch pass of the scratch path: seat the queued job with the
// least index, as dispatch_one.  st / busy point at this thread's job 0;
// job j sits `stride` elements further on.
__device__ __forceinline__ void dispatch_large(const int2* st, double* busy, size_t stride,
                                               const double* __restrict__ idx,
                                               const double* __restrict__ durs, int n, int m,
                                               int w_srv, int& nbusy, double clock) {
  double best = CUDART_INF;
  int bestj = n;
  for (int j = 0; j < n; ++j) {
    if (busy[j * stride] == CUDART_INF) {
      const int2 sj = st[j * stride];
      if (sj.x <= sj.y) {
        const double v = __ldg(idx + j * m + sj.x);
        if (v < best) {
          best = v;
          bestj = j;
        }
      }
    }
  }
  if (nbusy < w_srv && bestj < n) {
    busy[bestj * stride] = clock + __ldg(durs + bestj * m + st[bestj * stride].x);
    ++nbusy;
  }
}

template <bool kMC>
__global__ void __launch_bounds__(kThreads) dynamic_kernel_large(
    const double* __restrict__ tab,         // (N, M) stop probs (enum) / CDF (MC)
    const double* __restrict__ durs,        // (N, M) per-stage service increments
    const double* __restrict__ idx_tables,  // (P, N, M) index tables (+inf pad)
    const int* __restrict__ strides,        // (N,) mixed-radix strides (enum only)
    const int* __restrict__ radix,          // (N,) stage counts
    int n, int m, long long count, uint32_t k0, uint32_t k1, int total_stages,
    int w_srv, int orders_on_x, int2* __restrict__ st_all, double* __restrict__ busy_all,
    double* __restrict__ partials) {
  const GridPos g = grid_pos(orders_on_x);
  const double* idx = idx_tables + (size_t)g.p * n * m;
  const size_t stride = (size_t)gridDim.x * gridDim.y * blockDim.x;  // threads T
  const size_t tid = ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * blockDim.x + threadIdx.x;
  int2* st = st_all + tid;
  double* busy = busy_all + tid;

  const double w0 = kMC ? 1.0 / (double)count : 1.0;
  const double dn = (double)n;
  double acc_succ = 0.0, acc_all = 0.0;
  const long long step = (long long)g.nblk * blockDim.x;
  for (long long k = (long long)g.b * blockDim.x + threadIdx.x; k < count; k += step) {
    // --- decode: stop stage per job, Eq.-8 weight ---
    double w = w0;
    for (int j = 0; j < n; ++j) {
      const int r = __ldg(radix + j);
      int s;
      if constexpr (kMC) {
        const double u = uniform_from_bits(threefry2x32(k0, k1, (uint32_t)k, (uint32_t)j).x);
        int c = 0;
        for (int q = 0; q < m; ++q) c += (u >= __ldg(tab + j * m + q));
        s = min(c, r - 1);
      } else {
        s = (int)(((uint32_t)k / (uint32_t)__ldg(strides + j)) % (uint32_t)r);
        w *= __ldg(tab + j * m + s);
      }
      st[j * stride] = make_int2(0, s);
      busy[j * stride] = CUDART_INF;
    }

    // --- lockstep W-server simulation (stage-boundary preemption) ---
    int nbusy = 0;
    for (int i = 0; i < w_srv; ++i)  // t = 0: seat the W smallest indices
      dispatch_large(st, busy, stride, idx, durs, n, m, w_srv, nbusy, 0.0);
    double clock = 0.0, tot = 0.0, tsum = 0.0;
    int cnt = 0;
    for (int it = 0; it < total_stages; ++it) {
      // complete: pop the running job with the earliest finish time
      double tmin = CUDART_INF;
      int cjob = n;
      for (int j = 0; j < n; ++j) {
        const double b = busy[j * stride];
        if (b < tmin) {
          tmin = b;
          cjob = j;
        }
      }
      if (cjob < n) {
        clock = tmin;
        const int2 sj = st[cjob * stride];
        st[cjob * stride].x = sj.x + 1;
        busy[cjob * stride] = CUDART_INF;
        --nbusy;
        if (sj.x == sj.y) {
          tsum += clock;
          if (sj.y == __ldg(radix + cjob) - 1) {
            tot += clock;
            ++cnt;
          }
        }
      }
      // refill the freed server: at most one job (re)joined the queue
      dispatch_large(st, busy, stride, idx, durs, n, m, w_srv, nbusy, clock);
    }
    acc_succ += w * (cnt > 0 ? tot / (double)cnt : 0.0);
    acc_all += w * (tsum / dn);
  }
  write_partial(partials, g, acc_succ, acc_all);
}

template <bool kMC>
int launch_dynamic(const double* tab, const double* durs, const double* idx_tables,
                   const int* strides, const int* radix, int n_policies, int n,
                   int m, long long count, uint32_t k0, uint32_t k1,
                   int total_stages, int w_srv, void* scratch, int nblk, double* partials,
                   double* out, void* stream) {
  int orders_on_x;
  const dim3 grid = make_grid(n_policies, nblk, &orders_on_x);
  const size_t smem = 3 * (size_t)n * m * sizeof(double) + 2 * (size_t)n * sizeof(int);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > kRegisterJobs) {  // the scratch path: T x N int2, then T x N double
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    const size_t slots = (size_t)grid.x * grid.y * kThreads * n;
    int2* st_all = static_cast<int2*>(scratch);
    double* busy_all = reinterpret_cast<double*>(st_all + slots);
    dynamic_kernel_large<kMC><<<grid, kThreads, 0, st>>>(
        tab, durs, idx_tables, strides, radix, n, m, count, k0, k1, total_stages, w_srv,
        orders_on_x, st_all, busy_all, partials);
    return finish_launch(partials, nblk, n_policies, out, st);
  }
#define SOJOURN_LAUNCH(NMAX)                                                  \
  dynamic_kernel<NMAX, kMC><<<grid, kThreads, smem, st>>>(                    \
      tab, durs, idx_tables, strides, radix, n, m, count, k0, k1, total_stages, \
      w_srv, orders_on_x, partials)
  if (n <= 8) {
    SOJOURN_LAUNCH(8);
  } else if (n <= 16) {
    SOJOURN_LAUNCH(16);
  } else if (n <= 32) {
    SOJOURN_LAUNCH(32);
  } else {
    SOJOURN_LAUNCH(64);
  }
#undef SOJOURN_LAUNCH
  return finish_launch(partials, nblk, n_policies, out, st);
}

}  // namespace sojourn

// Exact evaluation of P index policies over K combinations on W servers.
// out (2, P): E[sojourn | successful], E[sojourn | all].  `scratch` is
// NULL up to 64 jobs, else 16 N bytes for each thread of the grid.
extern "C" int dynamic_enum_launch(const double* probs, const double* durs,
                                   const double* idx_tables, const int* strides,
                                   const int* radix, int n_policies, int n, int m,
                                   long long k_total, int total_stages, int w_srv,
                                   void* scratch, int nblk, double* partials, double* out,
                                   void* stream) {
  return sojourn::launch_dynamic<false>(probs, durs, idx_tables, strides, radix,
                                        n_policies, n, m, k_total, 0u, 0u,
                                        total_stages, w_srv, scratch, nblk, partials, out,
                                        stream);
}

// Streamed Monte Carlo over S samples under the key (k0, k1).
extern "C" int dynamic_mc_launch(const double* cdf, const double* durs,
                                 const double* idx_tables, const int* radix,
                                 int n_policies, int n, int m, long long n_samples,
                                 unsigned int k0, unsigned int k1, int total_stages,
                                 int w_srv, void* scratch, int nblk, double* partials,
                                 double* out, void* stream) {
  return sojourn::launch_dynamic<true>(cdf, durs, idx_tables, nullptr, radix,
                                       n_policies, n, m, n_samples, k0, k1,
                                       total_stages, w_srv, scratch, nblk, partials, out,
                                       stream);
}
