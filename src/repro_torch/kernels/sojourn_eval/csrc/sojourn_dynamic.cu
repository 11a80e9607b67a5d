// Fused E[sojourn] of stage-level index policies on W servers.
//
// Replaces the TPU kernels of repro/kernels/sojourn_eval/dynamic.py:
//   dynamic_sojourn_enum (_dynamic_kernel + _lockstep_sim) -> dynamic_enum_launch
//   dynamic_sojourn_mc   (_dynamic_mc_kernel + _lockstep_sim) -> dynamic_mc_launch
// These kernels do no matrix products: no tensor-core, TMA or wgmma path
// applies.  What bounds them is integer issue (Threefry for MC; the bit
// scans, table reads and the decode for both) and, through occupancy,
// the register file.
//
// Each thread owns one combination (or sample) at a time and runs the
// lockstep simulation of _lockstep_sim with O(1) work a step, on a total
// order of the policy's (job, stage) entries that the wrapper builds
// once a call (dynamic.py's queue_tables):
//   * an entry (j, s), s < M_j, is ranked when its index is neither +inf
//     nor NaN, by (index, job, stage).  That is the old scans' rule: a
//     strict < in job order with sentinel n, so ties go to the lowest job
//     and a +inf or NaN index is never seated (its job waits forever);
//   * Q, the queue, has bit r set while entry r's job waits at that
//     stage; it starts as every job's stage-0 entry (q0, one a policy);
//   * S, the stops, has bit r set when entry r is its job's decoded stop
//     stage; built from the decoded stages through rank_of;
//   * W slots hold (busy_until, rank, job) of the running entries.
// A step pops the slot with the least (busy_until, job) -- the old
// completion scan's order -- and sets the clock to it; if S holds its
// entry, adds the clock to tsum (and to tot, with one success, when the
// entry is the job's last stage), else queues the successor entry; then
// seats the lowest set bit of Q on the freed slot at clock + duration.
// At t = 0 it seats min(W, N) entries.  It stops when no slot runs
// (every later step of the old loop was a no-op) or after total_stages
// steps, as the old loop did.  The float64 adds are the old ones in the
// same order (busy = clock + dur; tsum, tot += clock; the weight product
// in job order), so each combination gives the old kernel's bits.  Stage
// durations are finite (an infinite one stalls its server: no slot
// pops).
//
// The enumeration decodes a thread's first index k and the grid stride
// once, with divisions, into packed mixed-radix digits (job j's digit in
// bits [lo_j, lo_j + width_j) of a 64-bit word, job N-1 lowest; any K <
// 2^31 needs at most 40 bits) and advances by adding the stride's digits
// with carries, from the stride's least significant non-zero digit up.
// Monte Carlo draws Threefry per (sample, job) with the inverse-CDF
// count, bitwise the reference's stream.
//
// Paths (picked at launch from the mask words NW = ceil(N M / 64) and W):
//   * registers: NW <= 4 (N M <= 256) and W <= 8.  Q, S and the slots
//     live in registers (templates NW in {1, 2, 4}, W in {1, 2, 4, 8});
//     one policy's tables are copied into shared memory.  Phase 3's
//     N = 26 and 27 and phase 3b's N = 80 group (NW = 3) take it.
//   * memory: past either limit.  Q, S and the slots live per thread in
//     shared memory, 16 bytes for each mask word and each slot, while a
//     block's state fits kSharedStateBytes; past that in device scratch
//     that the wrapper allocates (the same layout, on a grid cut to
//     kernel.py's SCRATCH_BLOCKS).  Loops run to NW and W at run time;
//     the tables are read from global memory.  Held by memory only.
// Reduction as in common.cuh: per-block partials summed in a fixed
// order, no fp64 atomics, so two calls give the same bits.
#include "common.cuh"
#include "threefry.cuh"

namespace sojourn {

constexpr int kRegisterWords = 4;            // mask words held in registers
constexpr int kRegisterServers = 8;          // server slots held in registers
constexpr int kSharedStateBytes = 96 * 1024; // a block's state on the memory path
constexpr int kStateBytes = 16;              // per mask word (Q and S) and per slot

// One policy's tables (shared memory on the register path, global on the
// memory path).
struct Tables {
  const double* tab;              // (N, M) stop probabilities (enum) / CDF (MC)
  const int* radix;               // (N,) stage counts
  const int* strides;             // (N,) mixed-radix strides (enum)
  const int2* field;              // (N,) {lo, width mask} of job j's packed digit (enum)
  const double* dur;              // (L,) duration of ranked entry r
  const int2* link;               // (L,) {rank of (j, s+1) or -1, 2 j + (s == M_j - 1)}
  const int* rank_of;             // (N, M) rank of (j, s) or -1
  const unsigned long long* q0;   // (NW,) every job's stage-0 entry
};

struct Args {
  const double* tab;
  const int* radix;
  const int* strides;
  const int2* field;
  const double* dur;              // (P, L)
  const int2* link;               // (P, L)
  const int* rank_of;             // (P, N, M)
  const unsigned long long* q0;   // (P, NW)
  int n, m, nw, w_srv, total_stages, orders_on_x;
  long long count;
  uint32_t k0, k1;
  double* partials;
};

__device__ __forceinline__ Tables policy_tables(const Args& a, int p) {
  const size_t len = (size_t)a.n * a.m;
  return {a.tab, a.radix, a.strides, a.field, a.dur + p * len, a.link + p * len,
          a.rank_of + p * len, a.q0 + (size_t)p * a.nw};
}

// --- masks over ranked entries ---------------------------------------------

template <int NW>
struct RegMask {
  unsigned long long w[NW];
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < NW; ++i) w[i] = 0ull;
  }
  __device__ __forceinline__ void load(const unsigned long long* src, int nw) {
#pragma unroll
    for (int i = 0; i < NW; ++i) w[i] = i < nw ? src[i] : 0ull;
  }
  __device__ __forceinline__ void set(int r) {
    const int k = r >> 6;
    const unsigned long long b = 1ull << (r & 63);
#pragma unroll
    for (int i = 0; i < NW; ++i)
      if (i == k) w[i] |= b;
  }
  __device__ __forceinline__ bool test(int r) const {
    const int k = r >> 6;
    unsigned long long v = 0ull;
#pragma unroll
    for (int i = 0; i < NW; ++i)
      if (i == k) v = w[i];
    return (v >> (r & 63)) & 1ull;
  }
  // The lowest set bit, cleared; -1 when empty.
  __device__ __forceinline__ int pop() {
    int r = -1;
#pragma unroll
    for (int i = NW - 1; i >= 0; --i)
      if (w[i]) r = i * 64 + __ffsll((long long)w[i]) - 1;
    const int k = r >> 6;
#pragma unroll
    for (int i = 0; i < NW; ++i)
      if (i == k) w[i] &= w[i] - 1;
    return r;
  }
};

// A thread's words at p[i * stride], i < nw; `lo` is the lowest word pop
// may find set.
struct MemMask {
  unsigned long long* p;
  size_t stride;
  int nw, lo;
  __device__ __forceinline__ void clear() {
    for (int i = 0; i < nw; ++i) p[i * stride] = 0ull;
    lo = nw;
  }
  __device__ __forceinline__ void load(const unsigned long long* src, int) {
    for (int i = 0; i < nw; ++i) p[i * stride] = src[i];
    lo = 0;
  }
  __device__ __forceinline__ void set(int r) {
    p[(r >> 6) * stride] |= 1ull << (r & 63);
    lo = min(lo, r >> 6);
  }
  __device__ __forceinline__ bool test(int r) const {
    return (p[(r >> 6) * stride] >> (r & 63)) & 1ull;
  }
  __device__ __forceinline__ int pop() {
    for (; lo < nw; ++lo) {
      const unsigned long long v = p[lo * stride];
      if (v) {
        p[lo * stride] = v & (v - 1);
        return lo * 64 + __ffsll((long long)v) - 1;
      }
    }
    return -1;
  }
};

// --- server slots ----------------------------------------------------------

template <int WR>
struct RegSlots {
  double busy[WR];
  int rank[WR], job[WR];
  __device__ __forceinline__ void clear(int) {
#pragma unroll
    for (int i = 0; i < WR; ++i) {
      busy[i] = CUDART_INF;
      rank[i] = -1;
      job[i] = 0x7fffffff;
    }
  }
  __device__ __forceinline__ void seat(int c, double b, int r, int j) {
#pragma unroll
    for (int i = 0; i < WR; ++i)
      if (i == c) {
        busy[i] = b;
        rank[i] = r;
        job[i] = j;
      }
  }
  // Empty the slot with the least (busy_until, job): its index, rank and
  // busy_until (+inf when no slot runs).
  __device__ __forceinline__ void pop(int& c, int& r, double& b, int) {
    b = busy[0];
    int bj = job[0];
    c = 0;
    r = rank[0];
#pragma unroll
    for (int i = 1; i < WR; ++i)
      if (busy[i] < b || (busy[i] == b && job[i] < bj)) {
        b = busy[i];
        bj = job[i];
        c = i;
      }
#pragma unroll
    for (int i = 0; i < WR; ++i)
      if (i == c) {
        r = rank[i];
        busy[i] = CUDART_INF;
        job[i] = 0x7fffffff;
      }
  }
};

// A thread's slots at busy[i * stride] and key[i * stride] = (rank, job), i < w.
struct MemSlots {
  double* busy;
  int2* key;
  size_t stride;
  __device__ __forceinline__ void clear(int w) {
    for (int i = 0; i < w; ++i) {
      busy[i * stride] = CUDART_INF;
      key[i * stride] = make_int2(-1, 0x7fffffff);
    }
  }
  __device__ __forceinline__ void seat(int c, double b, int r, int j) {
    busy[c * stride] = b;
    key[c * stride] = make_int2(r, j);
  }
  __device__ __forceinline__ void pop(int& c, int& r, double& b, int w) {
    b = CUDART_INF;
    int bj = 0x7fffffff;
    c = 0;
    r = -1;
    for (int i = 0; i < w; ++i) {
      const double bi = busy[i * stride];
      if (bi <= b) {
        const int2 ki = key[i * stride];
        if (bi < b || ki.y < bj) {
          b = bi;
          bj = ki.y;
          c = i;
          r = ki.x;
        }
      }
    }
    busy[c * stride] = CUDART_INF;
    key[c * stride] = make_int2(-1, 0x7fffffff);
  }
};

// --- the enumeration's packed digits ---------------------------------------

__device__ __forceinline__ unsigned long long pack_digits(const Tables& t, int n,
                                                          long long k) {
  unsigned long long x = 0ull;
  for (int j = 0; j < n; ++j) {
    const uint32_t d = ((uint32_t)k / (uint32_t)t.strides[j]) % (uint32_t)t.radix[j];
    x |= (unsigned long long)d << t.field[j].x;
  }
  return x;
}

// x += y in mixed radix, from job jlo (y's least significant non-zero digit)
// up to job 0, stopping once no carry is left above jtop (its most
// significant non-zero digit).
__device__ __forceinline__ void advance_digits(unsigned long long& x, unsigned long long y,
                                               const Tables& t, int jlo, int jtop) {
  uint32_t c = 0u;
  for (int j = jlo; j >= 0; --j) {
    if (j < jtop && c == 0u) break;
    const int2 f = t.field[j];
    const unsigned long long mask = (unsigned long long)(uint32_t)f.y;
    uint32_t d = (uint32_t)((x >> f.x) & mask) + (uint32_t)((y >> f.x) & mask) + c;
    const uint32_t r = (uint32_t)t.radix[j];
    c = d >= r;
    if (c) d -= r;
    x = (x & ~(mask << f.x)) | ((unsigned long long)d << f.x);
  }
}

// --- the simulation over a thread's indices ---------------------------------

template <bool kMC, class Mask, class Slots>
__device__ __forceinline__ void run(const Args& a, const Tables& t, const GridPos& g,
                                    Mask& Q, Mask& S, Slots& sl, double& acc_succ,
                                    double& acc_all) {
  const int n = a.n, m = a.m;
  const double w0 = kMC ? 1.0 / (double)a.count : 1.0;
  const double dn = (double)n;
  const long long step = (long long)g.nblk * blockDim.x;
  long long k = (long long)g.b * blockDim.x + threadIdx.x;
  if (k >= a.count) return;
  unsigned long long x = 0ull, y = 0ull;
  int jlo = -1, jtop = n;
  if constexpr (!kMC) {
    x = pack_digits(t, n, k);
    y = pack_digits(t, n, step);
    for (int j = 0; j < n; ++j) {
      if ((y >> t.field[j].x) & (unsigned long long)(uint32_t)t.field[j].y) {
        jlo = j;
        jtop = min(jtop, j);
      }
    }
  }
  for (; k < a.count; k += step) {
    // --- decode: the stop mask S and the Eq.-8 weight ---
    S.clear();
    double w = w0;
    for (int j = 0; j < n; ++j) {
      int s;
      if constexpr (kMC) {
        const double u = uniform_from_bits(
            threefry2x32(a.k0, a.k1, (uint32_t)k, (uint32_t)j).x);
        int c = 0;
        for (int q = 0; q < m; ++q) c += (u >= t.tab[j * m + q]);
        s = min(c, t.radix[j] - 1);
      } else {
        const int2 f = t.field[j];
        s = (int)((x >> f.x) & (unsigned long long)(uint32_t)f.y);
        w *= t.tab[j * m + s];
      }
      const int r = t.rank_of[j * m + s];
      if (r >= 0) S.set(r);
    }
    if constexpr (!kMC) advance_digits(x, y, t, jlo, jtop);

    // --- lockstep W-server simulation (stage-boundary preemption) ---
    Q.load(t.q0, a.nw);
    sl.clear(a.w_srv);
    double clock = 0.0, tot = 0.0, tsum = 0.0;
    int cnt = 0;
    for (int i = 0; i < a.w_srv; ++i) {  // t = 0: seat the W entries of least rank
      const int r = Q.pop();
      if (r < 0) break;
      sl.seat(i, clock + t.dur[r], r, t.link[r].y >> 1);
    }
    for (int it = 0; it < a.total_stages; ++it) {
      int c, r;
      double b;
      sl.pop(c, r, b, a.w_srv);  // complete: the earliest finish, ties to the lowest job
      if (!(b < CUDART_INF)) break;      // nothing runs: the rest were no-ops
      clock = b;
      const int2 lk = t.link[r];
      if (S.test(r)) {
        tsum += clock;
        if (lk.y & 1) {
          tot += clock;
          ++cnt;
        }
      } else if (lk.x >= 0) {
        Q.set(lk.x);
      }
      const int r2 = Q.pop();  // refill the freed server
      if (r2 >= 0) sl.seat(c, clock + t.dur[r2], r2, t.link[r2].y >> 1);
    }
    acc_succ += w * (cnt > 0 ? tot / (double)cnt : 0.0);
    acc_all += w * (tsum / dn);
  }
}

// Shared-memory bytes of one policy's tables on the register path.
inline size_t table_bytes(int n, int m, int nw) {
  const size_t len = (size_t)n * m;
  return len * (2 * sizeof(double) + sizeof(int2) + sizeof(int)) + nw * sizeof(long long) +
         n * (sizeof(int2) + 2 * sizeof(int));
}

template <bool kMC, int NW, int WR>
__global__ void __launch_bounds__(kThreads, 2) dynamic_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const GridPos g = grid_pos(a.orders_on_x);
  const Tables src = policy_tables(a, g.p);
  const int len = a.n * a.m;
  double* s_dur = reinterpret_cast<double*>(smem);
  double* s_tab = s_dur + len;
  unsigned long long* s_q0 = reinterpret_cast<unsigned long long*>(s_tab + len);
  int2* s_link = reinterpret_cast<int2*>(s_q0 + a.nw);
  int2* s_field = s_link + len;
  int* s_rank = reinterpret_cast<int*>(s_field + a.n);
  int* s_radix = s_rank + len;
  int* s_stride = s_radix + a.n;
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    s_dur[i] = src.dur[i];
    s_tab[i] = src.tab[i];
    s_link[i] = src.link[i];
    s_rank[i] = src.rank_of[i];
  }
  for (int i = threadIdx.x; i < a.n; i += blockDim.x) {
    s_radix[i] = src.radix[i];
    if constexpr (!kMC) {
      s_stride[i] = src.strides[i];
      s_field[i] = src.field[i];
    }
  }
  for (int i = threadIdx.x; i < a.nw; i += blockDim.x) s_q0[i] = src.q0[i];
  __syncthreads();
  const Tables t{s_tab, s_radix, s_stride, s_field, s_dur, s_link, s_rank, s_q0};
  RegMask<NW> Q, S;
  RegSlots<WR> sl;
  double acc_succ = 0.0, acc_all = 0.0;
  run<kMC>(a, t, g, Q, S, sl, acc_succ, acc_all);
  write_partial(a.partials, g, acc_succ, acc_all);
}

// The memory path: a thread's Q and S words, then its slots' busy_until and
// (rank, job), each array strided by `stride` threads, in dynamic shared
// memory (scratch == NULL) or in device scratch.  Without the occupancy
// hint ptxas gave the MC kernel 40 registers and spilled 72 bytes around
// the float64 division's slow-path call.
template <bool kMC>
__global__ void __launch_bounds__(kThreads, 2) dynamic_kernel_mem(Args a,
                                                               unsigned long long* scratch) {
  extern __shared__ unsigned long long s_state[];
  const GridPos g = grid_pos(a.orders_on_x);
  const Tables t = policy_tables(a, g.p);
  size_t stride;
  unsigned long long* base;
  if (scratch != nullptr) {
    stride = (size_t)gridDim.x * gridDim.y * blockDim.x;
    base = scratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * blockDim.x + threadIdx.x;
  } else {
    stride = blockDim.x;
    base = s_state + threadIdx.x;
  }
  MemMask Q{base, stride, a.nw, 0};
  MemMask S{base + a.nw * stride, stride, a.nw, 0};
  MemSlots sl{reinterpret_cast<double*>(base + 2 * a.nw * stride),
              reinterpret_cast<int2*>(base + (2 * a.nw + a.w_srv) * stride), stride};
  double acc_succ = 0.0, acc_all = 0.0;
  run<kMC>(a, t, g, Q, S, sl, acc_succ, acc_all);
  write_partial(a.partials, g, acc_succ, acc_all);
}

template <bool kMC, int NW>
void launch_registers(const Args& a, dim3 grid, size_t smem, cudaStream_t st) {
  if (a.w_srv == 1) {
    dynamic_kernel<kMC, NW, 1><<<grid, kThreads, smem, st>>>(a);
  } else if (a.w_srv == 2) {
    dynamic_kernel<kMC, NW, 2><<<grid, kThreads, smem, st>>>(a);
  } else if (a.w_srv <= 4) {
    dynamic_kernel<kMC, NW, 4><<<grid, kThreads, smem, st>>>(a);
  } else {
    dynamic_kernel<kMC, NW, 8><<<grid, kThreads, smem, st>>>(a);
  }
}

template <bool kMC>
int launch_dynamic(Args a, int n_policies, void* scratch, int nblk, double* out,
                   void* stream) {
  const dim3 grid = make_grid(n_policies, nblk, &a.orders_on_x);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.nw <= kRegisterWords && a.w_srv <= kRegisterServers) {
    const size_t smem = table_bytes(a.n, a.m, a.nw);
    if (a.nw == 1) {
      launch_registers<kMC, 1>(a, grid, smem, st);
    } else if (a.nw == 2) {
      launch_registers<kMC, 2>(a, grid, smem, st);
    } else {
      launch_registers<kMC, 4>(a, grid, smem, st);
    }
    return finish_launch(a.partials, nblk, n_policies, out, st);
  }
  const size_t state = (size_t)kStateBytes * (a.nw + a.w_srv) * kThreads;
  size_t smem = 0;
  if (scratch == nullptr) {  // the state in shared memory
    if (state > (size_t)kSharedStateBytes) return (int)cudaErrorInvalidValue;
    smem = state;
    const cudaError_t err = cudaFuncSetAttribute(
        dynamic_kernel_mem<kMC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dynamic_kernel_mem<kMC><<<grid, kThreads, smem, st>>>(
      a, static_cast<unsigned long long*>(scratch));
  return finish_launch(a.partials, nblk, n_policies, out, st);
}

}  // namespace sojourn

// Exact evaluation of P index policies over K combinations on W servers.
// out (2, P): E[sojourn | successful], E[sojourn | all].  The tables are
// dynamic.py's queue_tables (dur, link, rank_of, q0 with NW words) and
// digit_fields; `scratch` is NULL unless the memory path's state does not
// fit shared memory, else 16 (NW + W) bytes for each thread of the grid.
extern "C" int dynamic_enum_launch(const double* probs, const int* strides, const int* radix,
                                   const int* field, const double* dur, const int* link,
                                   const int* rank_of, const long long* q0, int n_policies,
                                   int n, int m, int nw, long long k_total, int total_stages,
                                   int w_srv, void* scratch, int nblk, double* partials,
                                   double* out, void* stream) {
  sojourn::Args a{probs, radix, strides, reinterpret_cast<const int2*>(field), dur,
                  reinterpret_cast<const int2*>(link), rank_of,
                  reinterpret_cast<const unsigned long long*>(q0), n, m, nw, w_srv,
                  total_stages, 0, k_total, 0u, 0u, partials};
  return sojourn::launch_dynamic<false>(a, n_policies, scratch, nblk, out, stream);
}

// Streamed Monte Carlo over S samples under the key (k0, k1).
extern "C" int dynamic_mc_launch(const double* cdf, const int* radix, const double* dur,
                                 const int* link, const int* rank_of, const long long* q0,
                                 int n_policies, int n, int m, int nw, long long n_samples,
                                 unsigned int k0, unsigned int k1, int total_stages, int w_srv,
                                 void* scratch, int nblk, double* partials, double* out,
                                 void* stream) {
  sojourn::Args a{cdf, radix, nullptr, nullptr, dur, reinterpret_cast<const int2*>(link),
                  rank_of, reinterpret_cast<const unsigned long long*>(q0), n, m, nw, w_srv,
                  total_stages, 0, n_samples, k0, k1, partials};
  return sojourn::launch_dynamic<true>(a, n_policies, scratch, nblk, out, stream);
}
