// Threefry2x32 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC'11) as device code, bit-equal to engine/krng.py. Included by
// fused_epoch.cu (K1's in-kernel bounce draws) and krng_draw.cu (K7), so
// both kernels share one cipher word for word.

#pragma once

#include <stdint.h>

namespace krng {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Key (k0, k1), counter (x0, x1); key injection after every four rounds.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t x0, uint32_t x1,
                                             int rounds, uint32_t* o0,
                                             uint32_t* o1) {
  const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
  for (int r = 0; r < rounds; ++r) {
    x0 += x1;
    x1 = rotl32(x1, rot[r % 8]);
    x1 ^= x0;
    if (r % 4 == 3) {
      const int g = r / 4 + 1;
      x0 += ks[g % 3];
      x1 += ks[(g + 1) % 3] + (uint32_t)g;
    }
  }
  *o0 = x0;
  *o1 = x1;
}

// krng.bounce_uniform's word: block (seed, t) x (id, bounce + 1), word 0.
__device__ __forceinline__ uint32_t bounce_word(uint32_t seed, uint32_t t,
                                                uint32_t id, uint32_t bounce) {
  uint32_t w0, w1;
  threefry2x32(seed, t, id, bounce + 1u, 13, &w0, &w1);
  return w0;
}

// krng.uniform01: the top 24 bits over 2^24, exact in float and double.
template <typename T>
__device__ __forceinline__ T uniform01(uint32_t w) {
  return (T)(w >> 8) * (T)(1.0 / 16777216.0);
}

}  // namespace krng
