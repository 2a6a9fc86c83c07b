// K7: the krng draws of one fused epoch or one bounce pass, one thread per
// spin.
//
// Has no Pallas counterpart: it replaces the threefry that XLA fuses into
// the JAX package's one-program window (disimpy_tpu/engine/krng.py:77-101,
// drawn at engine/fused.py:946). Without it the port drew each step's
// directions as ~140 masked int64 torch operators (engine/krng.py), each a
// launch of its own.
//
// Two functions, each in float32 and float64:
// - directions_kernel: the (J, 3, n) unit directions of steps t_base ..
//   t_base + J - 1 for the spins ids, the same function as
//   torch.stack([krng.unit_directions(seed, t_base + s, ids) for s in
//   range(J)]); each thread runs one spin and loops over the J steps;
// - uniforms_kernel: krng.bounce_uniform(seed, t, ids[idx], bounce) for a
//   gathered subset of spins (idx may be null), with one bounce index for
//   all of them or one per spin.
// seed and t come from device memory, so a captured CUDA graph replays the
// launch while the fused window (engine/fused.py) advances them there.
//
// What bounds it on the H100: the 12 bytes per spin-step it writes in
// float32 (24 in float64), ~8 us at J = 4 and 524,288 spins. The 13-round
// cipher is ~46 integer instructions per spin-step (a rotate is one funnel
// shift, a key injection folds into an IADD3), ~6 us at 64 INT32 lanes per
// SM. Neighbouring threads write neighbouring floats of each (step, axis)
// row, so every store is coalesced; nothing is read but the ids and the
// two scalars.
//
// Rounding: the directions and uniforms are threefry.cuh's
// (krng::unit_direction, krng::bounce_uniform), which follow krng.py
// operator by operator; K8 and K9 draw with the same functions.
//
// C interface (bound with ctypes): every entry point returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
directions_kernel(const int* __restrict__ seed_p,  // () RNG key
                  const int* __restrict__ t_p,     // () first step
                  const int* __restrict__ ids,     // (n,)
                  int n, int J,
                  T* __restrict__ out) {           // (J, 3, n)
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t seed = (uint32_t)__ldg(seed_p);
  const uint32_t t0 = (uint32_t)__ldg(t_p);
  const uint32_t id = (uint32_t)ids[i];
  for (int s = 0; s < J; ++s) {
    // krng.unit_directions(seed, t0 + s, id).
    T dir[3];
    krng::unit_direction<T>(seed, t0 + (uint32_t)s, id, dir);
    const size_t row = (size_t)(3 * s) * n + i;
    out[row] = dir[0];
    out[row + n] = dir[1];
    out[row + 2 * (size_t)n] = dir[2];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
uniforms_kernel(const int* __restrict__ seed_p,     // () RNG key
                const int* __restrict__ t_p,        // () step
                const int* __restrict__ ids,        // (n,)
                const int64_t* __restrict__ idx,    // (m,) or null
                const int* __restrict__ bounce_p,   // (m,) or null
                int bounce, int m,
                T* __restrict__ out) {              // (m,)
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  const uint32_t id = (uint32_t)ids[idx ? idx[i] : i];
  const uint32_t b = (uint32_t)(bounce_p ? bounce_p[i] : bounce);
  out[i] = krng::bounce_uniform<T>((uint32_t)__ldg(seed_p),
                                   (uint32_t)__ldg(t_p), id, b);
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// f64 selects the float64 kernel; out is float32 otherwise.
int krng_directions_launch(const void* seed, const void* t, const void* ids,
                           int n, int J, int f64, void* out, void* stream) {
  if (n > 0 && J > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (f64)
      directions_kernel<double><<<blocks(n), kThreads, 0, s>>>(
          (const int*)seed, (const int*)t, (const int*)ids, n, J,
          (double*)out);
    else
      directions_kernel<float><<<blocks(n), kThreads, 0, s>>>(
          (const int*)seed, (const int*)t, (const int*)ids, n, J,
          (float*)out);
  }
  return (int)cudaGetLastError();
}

// idx (int64) and bounce_arr (int32) may be null: then spin i of ids, and
// bounce index `bounce` for every spin.
int krng_uniforms_launch(const void* seed, const void* t, const void* ids,
                         const void* idx, const void* bounce_arr, int bounce,
                         int m, int f64, void* out, void* stream) {
  if (m > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (f64)
      uniforms_kernel<double><<<blocks(m), kThreads, 0, s>>>(
          (const int*)seed, (const int*)t, (const int*)ids,
          (const int64_t*)idx, (const int*)bounce_arr, bounce, m,
          (double*)out);
    else
      uniforms_kernel<float><<<blocks(m), kThreads, 0, s>>>(
          (const int*)seed, (const int*)t, (const int*)ids,
          (const int64_t*)idx, (const int*)bounce_arr, bounce, m,
          (float*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
