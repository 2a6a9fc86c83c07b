// K8: one classic time step on an analytic substrate (sphere, cylinder,
// ellipsoid): every spin's direction and first collision check in step,
// then the spins that still collide on dense warps.
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
// The schedule: a block of 128 threads takes 128 spins; each thread draws
// its spin's direction and runs its first check, and the spins that still
// collide (1.04-1.31 checks per spin in the phase 19 cases) join a queue
// in the block's shared memory (__ballot_sync and __popc, one shared
// atomic per warp); after a barrier, thread j carries queued spin j
// through its later checks, so those run on the block's first warps, dense,
// and not on every warp with most lanes masked, as when one thread ran its
// spin's whole loop. 128-thread blocks put the analytic MISST runs' 1e5
// spins on 782 blocks, all resident on the 132 SMs at once.
//
// What bounds it on the H100: not the bytes (24 or 48 read and 29 or 53
// written per spin-step: 0.0052 / 0.0089 ms at 524,288 spins, 0.0010 ms
// at 1e5) nor the masked later checks. Measured on an NVIDIA H100 80GB
// HBM3 at 700 W (scripts/classic_step_ab.py, the one-thread-per-spin
// kernel and this one in one call), the queue changes the time by -5% to
// +13%: 0.0156-0.0412 ms against 0.0148-0.0389 ms at 524,288 spins, and
// 0.0060-0.0076 against 0.0054-0.0068 ms at 1e5, where the launch is one
// wave and its time one spin's chain of dependent, correctly rounded
// divisions, square roots and threefry rounds. So K8 is latency-bound:
// each spin's check is a long dependent chain, and a warp-level queue or
// another block size leaves it there too. In an analytic MISST run K8 is
// ~5.5 of ~75 ms of device time; the phase product takes ~60.
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

constexpr int kThreads = 128;  // threads of a block, and its queue's slots
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

// The per-step values every check of a spin reads.
template <typename T>
struct SpinArgs {
  const T* g;     // radius, or the ellipsoid's 1 / semiaxes^2
  T perm, eps;
  uint32_t id;
};

template <typename T>
__device__ __forceinline__ SpinArgs<T> spin_args(
    int i, const int* __restrict__ ids, const T* __restrict__ geom,
    int geom_stride, const T* __restrict__ perm_p, int perm_stride,
    const T* __restrict__ eps_p, int eps_stride) {
  return SpinArgs<T>{geom + (long)i * geom_stride,
                     perm_p[(long)i * perm_stride],
                     eps_p[(long)i * eps_stride], (uint32_t)ids[i]};
}

// One collision check of a spin at r moving along dir with rem step
// lengths left: iters += 1; d = the forward root; on a hit (d > 0 and d <
// rem + slack) the uniform of bounce index iters - 1 decides cross or
// reflect, and rem -= d + epsilon. Returns whether the spin still collides
// (hit, rem > 0 and iters < max_iter).
template <typename T, int K>
__device__ __forceinline__ bool check(T r[3], T dir[3], T& rem, int& iters,
                                      int& cross, const SpinArgs<T>& sa,
                                      uint32_t seed, uint32_t t,
                                      int max_iter) {
  ++iters;
  T normal[3];
  const T d = distance_and_normal<T, K>(r, dir, sa.g, sa.perm, normal);
  const bool hit = d > (T)0 && d < add_rn(rem, slack_of(T(0)));
  if (hit) {
    const bool through = krng::bounce_uniform<T>(seed, t, sa.id,
                                                 (uint32_t)(iters - 1)) <
                         sa.perm;
    T v[3];
    for (int a = 0; a < 3; ++a) v[a] = mul_rn(d, dir[a]);
    const T dp = dot(v, normal);
    if (through) {
      // geometry.crossing_rows: epsilon past the wall, same direction.
      const T s = dp < (T)0 ? (T)-1 : (T)1;
      for (int a = 0; a < 3; ++a) {
        r[a] = add_rn(add_rn(r[a], v[a]), mul_rn(sa.eps, s * normal[a]));
      }
      ++cross;
    } else {
      // geometry.reflect_rows: mirror the direction, epsilon inside.
      const T s = dp > (T)0 ? (T)-1 : (T)1;
      const T two_dp = mul_rn((T)2, -fabs(dp));
      T w[3];
      for (int a = 0; a < 3; ++a) {
        const T na = s * normal[a];
        r[a] = add_rn(add_rn(r[a], v[a]), mul_rn(sa.eps, na));
        w[a] = sub_rn(v[a], mul_rn(two_dp, na));
      }
      normalize(w);
      for (int a = 0; a < 3; ++a) dir[a] = w[a];
    }
    rem = sub_rn(rem, add_rn(d, sa.eps));
  }
  return hit && rem > (T)0 && iters < max_iter;
}

// The spin's end of step: r + dir * rem, the budget flag, the crossings.
template <typename T>
__device__ __forceinline__ void write_spin(int i, int n, const T r[3],
                                           const T dir[3], T rem, int iters,
                                           int cross, int max_iter,
                                           T* __restrict__ out,
                                           uint8_t* __restrict__ exc,
                                           int* __restrict__ crossings) {
  for (int a = 0; a < 3; ++a) {
    out[(long)a * n + i] = add_rn(r[a], mul_rn(dir[a], rem));
  }
  exc[i] = iters >= max_iter;
  crossings[i] = cross;
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
  // The block's queue of spins that still collide after their first check:
  // index, position, direction, rem and crossings.
  __shared__ int q_count;
  __shared__ int q_spin[kThreads], q_cross[kThreads];
  __shared__ T q_r[3][kThreads], q_dir[3][kThreads], q_rem[kThreads];
  if (threadIdx.x == 0) q_count = 0;
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const uint32_t seed = (uint32_t)__ldg(seed_p);
  const uint32_t t = (uint32_t)__ldg(t_p);
  // Check 1, every spin of the block in step: draw, root, resolve.
  T dir[3], r[3], rem = (T)1;
  int iters = 0, cross = 0;
  bool active = false;
  if (i < n) {
    const SpinArgs<T> sa = spin_args(i, ids, geom, geom_stride, perm_p,
                                     perm_stride, eps_p, eps_stride);
    krng::unit_direction<T>(seed, t, sa.id, dir);
    for (int a = 0; a < 3; ++a) r[a] = pos[(long)a * n + i];
    active = check<T, K>(r, dir, rem, iters, cross, sa, seed, t, max_iter);
    if (!active) {
      write_spin(i, n, r, dir, rem, iters, cross, max_iter, out, exc,
                 crossings);
    }
  }
  // The spins that still collide join the queue: one atomic per warp.
  const int lane = threadIdx.x & 31;
  const unsigned mask = __ballot_sync(0xffffffffu, active);
  int base = 0;
  if (lane == 0 && mask != 0u) base = atomicAdd(&q_count, __popc(mask));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (active) {
    const int j = base + __popc(mask & ((1u << lane) - 1u));
    q_spin[j] = i;
    q_cross[j] = cross;
    q_rem[j] = rem;
    for (int a = 0; a < 3; ++a) {
      q_r[a][j] = r[a];
      q_dir[a][j] = dir[a];
    }
  }
  __syncthreads();
  // Checks 2 and later on dense warps: thread j takes queued spin j.
  const int j = threadIdx.x;
  if (j >= q_count) return;
  const int k = q_spin[j];
  const SpinArgs<T> sa = spin_args(k, ids, geom, geom_stride, perm_p,
                                   perm_stride, eps_p, eps_stride);
  for (int a = 0; a < 3; ++a) {
    r[a] = q_r[a][j];
    dir[a] = q_dir[a][j];
  }
  rem = q_rem[j];
  cross = q_cross[j];
  iters = 1;
  while (check<T, K>(r, dir, rem, iters, cross, sa, seed, t, max_iter)) {
  }
  write_spin(k, n, r, dir, rem, iters, cross, max_iter, out, exc, crossings);
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
