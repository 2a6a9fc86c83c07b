// K8: one classic time step on an analytic substrate (sphere, cylinder,
// ellipsoid), one thread per spin, its whole bounce loop in the thread.
//
// Has no Pallas counterpart: it replaces the XLA ops of the JAX package's
// masked bounce loop (disimpy_tpu/engine/stepping.py:143-176, a
// lax.while_loop inside the lax.scan over steps). The port's plain version
// is engine/stepping.py (step_sphere / step_cylinder / step_ellipsoid over
// _bounce_analytic), a Python loop of ~60 torch operators per bounce pass
// that reads one flag back from the device per pass.
//
// Per spin: draw the step's direction (krng.unit_directions, keyed by
// (seed, t, id) as engine/rng.step_directions keys it), then loop
//   iters += 1; d = the forward root of the quadric (the far root when the
//   compartment is impermeable); hit = d > 0 && d < rem + slack; on a hit
//   draw the uniform of collision check iters (bounce index iters - 1) and
//   cross (u < perm_prob) or reflect; rem -= d + epsilon;
//   active = hit && rem > 0 && iters < max_iter,
// and write r0 + dir * rem, iters >= max_iter and the crossings. A spin's
// k-th check draws at bounce index k - 1, as the batched plain loop keys
// it by pass index, so the two draw the same uniforms.
//
// What bounds it on the H100: the bytes, 24 (float32) or 48 (float64) read
// and 29 / 53 written per spin-step (positions in and out, ids, exc,
// crossings); ~50 floating-point operations per bounce pass and ~90 for
// the draw are far below the card's rates at ~1-2 passes per step. The
// (3, n) rows are read and written by neighbouring threads at neighbouring
// addresses, so every access is coalesced.
//
// Rounding: every operation follows the torch operator the plain version
// applies, one IEEE operation each (krng::mul_rn and friends: nvcc must not
// contract a product into an FMA), divisions and square roots correctly
// rounded, and each three-term sum over the (3, n) rows taken as torch's
// CUDA reduction over dim 0 takes it, (a0 + a1) + a2 (torch's internals,
// probed with torch 2.11.0+cu128 on an H100; phase 19 of chip_smoke.py
// holds K8 to the plain version bit for bit, so another order fails it).
// Never build with --use_fast_math.
//
// Radius (sphere, cylinder), perm_prob and epsilon may each be one value or
// one per spin (stride 0 or 1); the ellipsoid takes one set of semiaxes,
// as 1 / semiaxes^2 computed by the wrapper as the plain version computes
// it. seed and t are read from
// device memory, so a captured CUDA graph replays the launch while the
// classic window (engine/core.py) advances them there.
//
// C interface (bound with ctypes): analytic_step_launch returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

using krng::add_rn;
using krng::div_rn;
using krng::mul_rn;
using krng::sqrt_rn;
using krng::sub_rn;

constexpr int kThreads = 256;
enum Kind { kSphere = 0, kCylinder = 1, kEllipsoid = 2 };

__device__ __forceinline__ float inf_of(float) { return CUDART_INF_F; }
__device__ __forceinline__ double inf_of(double) { return CUDART_INF; }
// stepping._hit_slack.
__device__ __forceinline__ float slack_of(float) { return 1e-5f; }
__device__ __forceinline__ double slack_of(double) { return 1e-12; }

// torch.sum over dim 0 of a (3, n) tensor.
template <typename T>
__device__ __forceinline__ T sum3(T a0, T a1, T a2) {
  return add_rn(add_rn(a0, a1), a2);
}

template <typename T>
__device__ __forceinline__ T dot(const T a[3], const T b[3]) {
  return sum3(mul_rn(a[0], b[0]), mul_rn(a[1], b[1]), mul_rn(a[2], b[2]));
}

// geometry.normalize_rows, in place.
template <typename T>
__device__ __forceinline__ void normalize(T v[3]) {
  const T norm = sqrt_rn(dot(v, v));
  for (int a = 0; a < 3; ++a) v[a] = div_rn(v[a], norm);
}

// stepping._smallest_positive_root.
template <typename T>
__device__ __forceinline__ T forward_root(T A, T B, T C, T perm) {
  const T disc = sub_rn(mul_rn(B, B), mul_rn(mul_rn((T)4, A), C));
  const bool ok = disc >= (T)0 && A > (T)0;
  const T sq = sqrt_rn(ok ? disc : (T)0);
  // 0.5 / A is torch's reciprocal(A) * 0.5.
  const T inv = mul_rn(div_rn((T)1, ok ? A : (T)1), (T)0.5);
  const T r1 = mul_rn(sub_rn(-B, sq), inv);
  const T r2 = mul_rn(add_rn(-B, sq), inv);
  const T inf = inf_of(T(0));
  const T far = r2 > (T)0 ? r2 : inf;
  const T near_first = r1 > slack_of(T(0)) ? r1 : far;
  const T d = perm > (T)0 ? near_first : far;
  return ok ? d : inf;
}

// The distance to the surface along dir (+inf on a miss) and the surface
// normal at the hit point (either orientation), as the plain version's
// distance_and_normal computes them. g points at the spin's radius
// (sphere, cylinder) or at the ellipsoid's three 1 / semiaxes^2.
template <typename T, int K>
__device__ __forceinline__ T distance_and_normal(const T r[3], const T dir[3],
                                                 const T* g, T perm,
                                                 T normal[3]) {
  T d;
  if (K == kSphere) {
    const T B = mul_rn((T)2, dot(dir, r));
    const T C = sub_rn(dot(r, r), mul_rn(g[0], g[0]));
    d = forward_root((T)1, B, C, perm);
    for (int a = 0; a < 3; ++a) {
      normal[a] = -add_rn(r[a], mul_rn(d, dir[a]));
    }
  } else if (K == kCylinder) {
    // Two-term sums: addition commutes, so their order cannot matter.
    const T A = add_rn(mul_rn(dir[1], dir[1]), mul_rn(dir[2], dir[2]));
    const T B = mul_rn((T)2, add_rn(mul_rn(r[1], dir[1]),
                                    mul_rn(r[2], dir[2])));
    const T C = sub_rn(add_rn(mul_rn(r[1], r[1]), mul_rn(r[2], r[2])),
                       mul_rn(g[0], g[0]));
    d = forward_root(A, B, C, perm);
    normal[0] = (T)0;
    for (int a = 1; a < 3; ++a) {
      normal[a] = -add_rn(r[a], mul_rn(d, dir[a]));
    }
  } else {
    const T inv2[3] = {g[0], g[1], g[2]};
    T pa[3], pb[3], pc[3];
    for (int a = 0; a < 3; ++a) {
      pa[a] = mul_rn(mul_rn(dir[a], dir[a]), inv2[a]);
      pb[a] = mul_rn(mul_rn(dir[a], r[a]), inv2[a]);
      pc[a] = mul_rn(mul_rn(r[a], r[a]), inv2[a]);
    }
    const T A = sum3(pa[0], pa[1], pa[2]);
    const T B = mul_rn((T)2, sum3(pb[0], pb[1], pb[2]));
    const T C = sub_rn(sum3(pc[0], pc[1], pc[2]), (T)1);
    d = forward_root(A, B, C, perm);
    for (int a = 0; a < 3; ++a) {
      normal[a] = mul_rn(-add_rn(r[a], mul_rn(d, dir[a])), inv2[a]);
    }
  }
  normalize(normal);
  return d;
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads) analytic_step_kernel(
    const T* __restrict__ pos,       // (3, n) start of the step
    const int* __restrict__ ids,     // (n,) spin ids keying the draws
    const int* __restrict__ seed_p,  // () RNG key
    const int* __restrict__ t_p,     // () step
    const T* __restrict__ geom, int geom_stride,
    const T* __restrict__ perm_p, int perm_stride,
    const T* __restrict__ eps_p, int eps_stride,
    int n, int max_iter,
    T* __restrict__ out,             // (3, n) end of the step
    uint8_t* __restrict__ exc,       // (n,) bool
    int* __restrict__ crossings) {   // (n,)
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t seed = (uint32_t)__ldg(seed_p);
  const uint32_t t = (uint32_t)__ldg(t_p);
  const uint32_t id = (uint32_t)ids[i];
  const T* g = geom + (long)i * geom_stride;
  const T perm = perm_p[(long)i * perm_stride];
  const T eps = eps_p[(long)i * eps_stride];
  const T slack = slack_of(T(0));
  T dir[3], r[3];
  krng::unit_direction<T>(seed, t, id, dir);
  for (int a = 0; a < 3; ++a) r[a] = pos[(long)a * n + i];
  T rem = (T)1;
  int iters = 0, cross = 0;
  bool active = true;
  while (active) {
    ++iters;
    T normal[3];
    const T d = distance_and_normal<T, K>(r, dir, g, perm, normal);
    const bool hit = d > (T)0 && d < add_rn(rem, slack);
    if (hit) {
      // Collision check `iters` draws at bounce index iters - 1.
      const bool through =
          krng::bounce_uniform<T>(seed, t, id, (uint32_t)(iters - 1)) < perm;
      T v[3];
      for (int a = 0; a < 3; ++a) v[a] = mul_rn(d, dir[a]);
      const T dp = dot(v, normal);
      if (through) {
        // geometry.crossing_rows: epsilon past the wall, same direction.
        const T s = dp < (T)0 ? (T)-1 : (T)1;
        for (int a = 0; a < 3; ++a) {
          r[a] = add_rn(add_rn(r[a], v[a]), mul_rn(eps, s * normal[a]));
        }
        ++cross;
      } else {
        // geometry.reflect_rows: mirror the direction, epsilon inside.
        const T s = dp > (T)0 ? (T)-1 : (T)1;
        const T two_dp = mul_rn((T)2, -fabs(dp));
        T w[3];
        for (int a = 0; a < 3; ++a) {
          const T na = s * normal[a];
          r[a] = add_rn(add_rn(r[a], v[a]), mul_rn(eps, na));
          w[a] = sub_rn(v[a], mul_rn(two_dp, na));
        }
        normalize(w);
        for (int a = 0; a < 3; ++a) dir[a] = w[a];
      }
      rem = sub_rn(rem, add_rn(d, eps));
    }
    active = hit && rem > (T)0 && iters < max_iter;
  }
  for (int a = 0; a < 3; ++a) {
    out[(long)a * n + i] = add_rn(r[a], mul_rn(dir[a], rem));
  }
  exc[i] = iters >= max_iter;
  crossings[i] = cross;
}

template <typename T, int K>
void launch(const void* pos, const void* ids, const void* seed, const void* t,
            const void* geom, int geom_stride, const void* perm,
            int perm_stride, const void* eps, int eps_stride, int n,
            int max_iter, void* out, void* exc, void* crossings,
            cudaStream_t s) {
  analytic_step_kernel<T, K><<<(n + kThreads - 1) / kThreads, kThreads, 0,
                               s>>>(
      (const T*)pos, (const int*)ids, (const int*)seed, (const int*)t,
      (const T*)geom, geom_stride, (const T*)perm, perm_stride,
      (const T*)eps, eps_stride, n, max_iter, (T*)out, (uint8_t*)exc,
      (int*)crossings);
}

template <typename T>
int dispatch(int kind, const void* pos, const void* ids, const void* seed,
             const void* t, const void* geom, int geom_stride,
             const void* perm, int perm_stride, const void* eps,
             int eps_stride, int n, int max_iter, void* out, void* exc,
             void* crossings, cudaStream_t s) {
  switch (kind) {
    case kSphere:
      launch<T, kSphere>(pos, ids, seed, t, geom, geom_stride, perm,
                         perm_stride, eps, eps_stride, n, max_iter, out, exc,
                         crossings, s);
      break;
    case kCylinder:
      launch<T, kCylinder>(pos, ids, seed, t, geom, geom_stride, perm,
                           perm_stride, eps, eps_stride, n, max_iter, out,
                           exc, crossings, s);
      break;
    case kEllipsoid:
      launch<T, kEllipsoid>(pos, ids, seed, t, geom, geom_stride, perm,
                            perm_stride, eps, eps_stride, n, max_iter, out,
                            exc, crossings, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// kind: 0 sphere, 1 cylinder, 2 ellipsoid; f64 selects the float64 kernel.
// Each *_stride is 0 (one value for every spin) or 1 (one per spin).
int analytic_step_launch(int kind, int f64, const void* pos, const void* ids,
                         const void* seed, const void* t, const void* geom,
                         int geom_stride, const void* perm, int perm_stride,
                         const void* eps, int eps_stride, int n, int max_iter,
                         void* out, void* exc, void* crossings,
                         void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (f64)
    return dispatch<double>(kind, pos, ids, seed, t, geom, geom_stride, perm,
                            perm_stride, eps, eps_stride, n, max_iter, out,
                            exc, crossings, s);
  return dispatch<float>(kind, pos, ids, seed, t, geom, geom_stride, perm,
                         perm_stride, eps, eps_stride, n, max_iter, out, exc,
                         crossings, s);
}

}  // extern "C"
