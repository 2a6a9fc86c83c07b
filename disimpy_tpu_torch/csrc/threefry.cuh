// Threefry2x32 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC'11) as device code, bit-equal to engine/krng.py, and the two draws
// made from it: a step's unit direction and a collision's uniform. Included
// by fused_epoch.cu (K1's in-kernel bounce draws), krng_draw.cu (K7),
// analytic_step.cu (K8) and mesh_hit.cu (K9), so every kernel shares one
// cipher and one draw arithmetic word for word.
//
// The draws follow krng.py operator by operator: every product and
// difference is rounded on its own (the *_rn helpers below, so nvcc cannot
// contract 1 - z * z into an FMA), sqrt is correctly rounded, 2 pi is the
// float32 (or float64) constant torch multiplies by, and cos / sin are the
// CUDA math library's, which torch's own CUDA cos / sin call. Never build
// with --use_fast_math.

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

// krng.bounce_uniform: the uniform of collision resolve `bounce` (0-based).
template <typename T>
__device__ __forceinline__ T bounce_uniform(uint32_t seed, uint32_t t,
                                            uint32_t id, uint32_t bounce) {
  return uniform01<T>(bounce_word(seed, t, id, bounce));
}

// One IEEE operation each, rounded to nearest: what one torch elementwise
// operator computes.
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float max0(float a) { return fmaxf(a, 0.0f); }
__device__ __forceinline__ double max0(double a) { return fmax(a, 0.0); }
__device__ __forceinline__ float cos_(float a) { return cosf(a); }
__device__ __forceinline__ double cos_(double a) { return cos(a); }
__device__ __forceinline__ float sin_(float a) { return sinf(a); }
__device__ __forceinline__ double sin_(double a) { return sin(a); }

// krng.unit_directions(seed, t, id): Archimedes sampling, z uniform in
// [-1, 1] and a uniform azimuth, from the block (seed, t) x (id, 0).
template <typename T>
__device__ __forceinline__ void unit_direction(uint32_t seed, uint32_t t,
                                               uint32_t id, T out[3]) {
  uint32_t w0, w1;
  threefry2x32(seed, t, id, 0u, 13, &w0, &w1);
  const T u0 = uniform01<T>(w0);
  const T u1 = uniform01<T>(w1);
  const T two_pi = (T)(2.0 * 3.14159265358979323846);
  const T z = sub_rn((T)1, mul_rn((T)2, u0));
  const T rho = sqrt_rn(max0(sub_rn((T)1, mul_rn(z, z))));
  const T phi = mul_rn(two_pi, u1);
  out[0] = mul_rn(rho, cos_(phi));
  out[1] = mul_rn(rho, sin_(phi));
  out[2] = z;
}

}  // namespace krng
