// Launch geometry and the deterministic two-pass reduction shared by the
// static and dynamic sojourn kernels.
//
// A TPU grid runs its combination tiles in order and carries the sum in a
// scratch tile; Hopper blocks run in no order.  So every block writes its
// own partial sums to partials[(p, b, 0..1)] and a second small kernel
// adds each order's partials in a fixed order.  No fp64 atomics: two runs
// give the same bits.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace sojourn {

constexpr int kThreads = 256;  // threads of a main-kernel block
constexpr int kWarps = kThreads / 32;

// (order or policy p, block b of its index range, blocks per order).  The
// larger of the two counts sits on gridDim.x: y stops at 65535.
struct GridPos {
  int p, b, nblk;
};

__device__ __forceinline__ GridPos grid_pos(int orders_on_x) {
  GridPos g;
  g.p = orders_on_x ? blockIdx.x : blockIdx.y;
  g.b = orders_on_x ? blockIdx.y : blockIdx.x;
  g.nblk = orders_on_x ? gridDim.y : gridDim.x;
  return g;
}

inline dim3 make_grid(int n_orders, int nblk, int* orders_on_x) {
  *orders_on_x = n_orders > nblk;
  return *orders_on_x ? dim3(n_orders, nblk) : dim3(nblk, n_orders);
}

// Block-wide sum of (a, b) in a fixed order; the result is in thread 0.
__device__ __forceinline__ void block_sum2(double& a, double& b) {
  __shared__ double sa[kWarps];
  __shared__ double sb[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = 0.0;
    b = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      a += sa[w];
      b += sb[w];
    }
  }
}

__device__ __forceinline__ void write_partial(double* partials, const GridPos& g,
                                              double acc_succ, double acc_all) {
  block_sum2(acc_succ, acc_all);
  if (threadIdx.x == 0) {
    const size_t at = ((size_t)g.p * g.nblk + g.b) * 2;
    partials[at] = acc_succ;
    partials[at + 1] = acc_all;
  }
}

// partials (P, nblk, 2) -> out (2, P): one warp per order, fixed order.
static __global__ void reduce_partials(const double* __restrict__ partials,
                                       int nblk, int n_orders,
                                       double* __restrict__ out) {
  const int p = blockIdx.x;
  const int lane = threadIdx.x;
  double a = 0.0, b = 0.0;
  for (int i = lane; i < nblk; i += 32) {
    const size_t at = ((size_t)p * nblk + i) * 2;
    a += partials[at];
    b += partials[at + 1];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  if (lane == 0) {
    out[p] = a;
    out[n_orders + p] = b;
  }
}

// Second pass plus the launch checks; returns a cudaError_t as int.
inline int finish_launch(const double* partials, int nblk, int n_orders,
                         double* out, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials<<<n_orders, 32, 0, stream>>>(partials, nblk, n_orders, out);
  return (int)cudaGetLastError();
}

}  // namespace sojourn

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
