// 20-round Threefry-2x32 (Salmon et al., Random123) on native uint32_t.
//
// The same block as threefry2x32 in ../rng.py (and in the JAX package's
// rng.py): key words (k0, k1, k0 ^ k1 ^ 0x1BD11BDA), rotations
// (13, 15, 26, 6) and (17, 29, 16, 24) alternating per group of four
// rounds, and a key injection plus the group number after each group.
// The streamed Monte-Carlo kernels call it with x0 = sample index and
// x1 = job id, so their outcome streams match the host replay bitwise.
#pragma once

#include <stdint.h>

namespace sojourn {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Returns both output words; the evaluators use .x.
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1) {
  const uint32_t ks2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
#define SOJOURN_TF_ROUND(r) \
  x0 += x1;                 \
  x1 = rotl32(x1, r);       \
  x1 ^= x0;
  SOJOURN_TF_ROUND(13) SOJOURN_TF_ROUND(15) SOJOURN_TF_ROUND(26) SOJOURN_TF_ROUND(6)
  x0 += k1;
  x1 += ks2 + 1u;
  SOJOURN_TF_ROUND(17) SOJOURN_TF_ROUND(29) SOJOURN_TF_ROUND(16) SOJOURN_TF_ROUND(24)
  x0 += ks2;
  x1 += k0 + 2u;
  SOJOURN_TF_ROUND(13) SOJOURN_TF_ROUND(15) SOJOURN_TF_ROUND(26) SOJOURN_TF_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  SOJOURN_TF_ROUND(17) SOJOURN_TF_ROUND(29) SOJOURN_TF_ROUND(16) SOJOURN_TF_ROUND(24)
  x0 += k1;
  x1 += ks2 + 4u;
  SOJOURN_TF_ROUND(13) SOJOURN_TF_ROUND(15) SOJOURN_TF_ROUND(26) SOJOURN_TF_ROUND(6)
  x0 += ks2;
  x1 += k0 + 5u;
#undef SOJOURN_TF_ROUND
  return make_uint2(x0, x1);
}

// The key schedule of threefry2x32 under one key, computed once a kernel:
// the initial adds (k0 to x0, k1 to x1) and the words added to x0 (a) and
// to x1 (b, with the group number) after each group of four rounds.  The
// fifth x1 word feeds only the .y output and is left out.
struct ThreefryKey {
  uint32_t k0, k1;
  uint32_t a[5], b[4];
};

__device__ __forceinline__ ThreefryKey threefry_key(uint32_t k0, uint32_t k1) {
  const uint32_t ks2 = k0 ^ k1 ^ 0x1BD11BDAu;
  return ThreefryKey{k0, k1, {k1, ks2, k0, k1, ks2}, {ks2 + 1u, k0 + 2u, k1 + 3u, ks2 + 4u}};
}

// The .x word of threefry2x32(k0, k1, x0, x1), given x0 + k0 and x1 + k1
// (so a caller adds each once, outside its loop over the other).  The last
// round's rotate and xor and the last x1 injection feed only .y: 19
// rotates, 19 xors and 29 adds a block.  The rotates and xors run only on
// the SM's integer ALU pipe; an add can run there or as an IMAD on the FMA
// pipe, and ptxas put some key injections on the ALU.  So the injections
// are written x * one + k with `one` a run-time 1 (a kernel argument, which
// neither compiler can fold): an IMAD each, which leaves the ALU pipe to the
// rotates and xors.
__device__ __forceinline__ uint32_t threefry2x32_x(const ThreefryKey& key, uint32_t x0,
                                                   uint32_t x1, uint32_t one) {
#define SOJOURN_TF_ROUND(r)          \
  x0 += x1;                          \
  x1 = __funnelshift_l(x1, x1, r);   \
  x1 ^= x0;
  SOJOURN_TF_ROUND(13) SOJOURN_TF_ROUND(15) SOJOURN_TF_ROUND(26) SOJOURN_TF_ROUND(6)
  x0 = x0 * one + key.a[0];
  x1 = x1 * one + key.b[0];
  SOJOURN_TF_ROUND(17) SOJOURN_TF_ROUND(29) SOJOURN_TF_ROUND(16) SOJOURN_TF_ROUND(24)
  x0 = x0 * one + key.a[1];
  x1 = x1 * one + key.b[1];
  SOJOURN_TF_ROUND(13) SOJOURN_TF_ROUND(15) SOJOURN_TF_ROUND(26) SOJOURN_TF_ROUND(6)
  x0 = x0 * one + key.a[2];
  x1 = x1 * one + key.b[2];
  SOJOURN_TF_ROUND(17) SOJOURN_TF_ROUND(29) SOJOURN_TF_ROUND(16) SOJOURN_TF_ROUND(24)
  x0 = x0 * one + key.a[3];
  x1 = x1 * one + key.b[3];
  SOJOURN_TF_ROUND(13) SOJOURN_TF_ROUND(15) SOJOURN_TF_ROUND(26)
#undef SOJOURN_TF_ROUND
  x0 += x1;  // the twentieth round: its rotate and xor feed only .y
  return x0 * one + key.a[4];
}

// bits * 2^-32: exact in double, so u >= cdf compares as on the host.
__device__ __forceinline__ double uniform_from_bits(uint32_t bits) {
  return (double)bits * 0x1p-32;
}

}  // namespace sojourn
