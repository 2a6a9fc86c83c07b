// One J-step epoch of fused mesh physics, eight lanes per spin.
//
// Replaces disimpy_tpu/engine/pallas_fused.py:277 (_kernel, launched by
// _launch, wrapped by fused_epoch). Spins arrive sorted by anchor cell;
// each group of eight consecutive lanes runs all J steps of one spin: a
// fresh unit direction and a full segment per step, then bounce passes
// until the segment is used up or max_iter is hit. A pass folds the
// distance-ordered prefix of the anchor cell's row that the spin can
// reach (feature-form Moller-Trumbore, strict-< running minimum, ties to
// the lowest sublane r, then to the earliest (unit, group)), then
// reflects or, with probability perm, crosses the nearest hit.
//
// What bounds it on the H100: the fp32 issue rate of the fold (about 17
// units of 64 triangles per spin and epoch on the bench bundle, ~40
// operations per triangle), not DRAM: spins sorted by anchor cell share
// rows, so L1 and L2 serve the table (16 floats per triangle, four float4
// loads). Run one thread per spin, the fold was held back by divergence:
// each lane's prefix count (0-63 units) and number of bounce passes
// differ, so a warp ran the maximum of both over 32 spins, 64 triangles
// per unit one after another.
//
// What the design does about it:
// - each spin picks its OWN prefix level from its own reach (distance to
//   the anchor-cell box + remaining segment + margin) instead of the
//   TPU's maximum over a (run x 128-lane block) segment, so a settled or
//   short-segment spin folds no more than it needs (on the TPU,
//   benchmarks/README.md reports a fold-lane occupancy of 0.401 under the
//   shared level); both choices cover every triangle within reach;
// - lane r of a spin's group folds sublane r of every group g of every
//   unit (the unit layout puts triangle 8g + r at sublane r), 8 triangles
//   per unit instead of 64, keeping its earliest (unit, g) for equal t;
//   three shuffle rounds then reduce the group by (t, r), which is the
//   serial order. Divergence is then among the 4 spins of a warp, not 32;
// - the eight lanes read their triangles' quads side by side: the kernel
//   takes a quad-major copy of the table (engine/fused_kernel.quad_major),
//   so each float4 load of a group is one 128-byte line. In the JAX
//   layout the eight sublanes lie 512 bytes apart, a load touched eight
//   lines, and the fold waited on L1;
// - the pass set-up, the in-kernel threefry and the resolve run in all
//   eight lanes on identical values, so no broadcast is needed; lane 0
//   writes the outputs.
//
// Counting variant (kCount, the port of the JAX package's
// fused_count_units): the same physics, plus per spin the units it folds
// and the bounce passes it runs (summed over the epoch's steps), and per
// warp the unit folds it issues: in each pass its four lane-groups run
// the largest prefix of the warp's spins still active, so the warp issues
// four times that many. To see every pass of every spin of the warp, the
// variant keeps the warp's lanes in step: a settled spin's lanes idle
// through the passes of the others (__ballot_sync), which gives the same
// values. The default variant compiles none of it.
//
// C interface (bound with ctypes): every entry point returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kBits = 6;
constexpr int kMask6 = (1 << kBits) - 1;
constexpr int kNumFine = 5;
constexpr int kMaxJ = 5;
constexpr float kEdgeTol = 1e-5f;   // barycentric leak-proofing tolerance
constexpr float kSlack = 1e-5f;     // hit-acceptance slack (step lengths)
constexpr float kReqMargin = 0.05f; // margin on the reach before the ladder
constexpr int kLanes = 8;           // lanes per spin: one per sublane r
constexpr int kThreads = 128;       // threads per block
constexpr int kSpinsPerWarp = 32 / kLanes;

// krng.bounce_uniform: uniform in [0, 1) for the it-th collision resolve.
__device__ __forceinline__ float bounce_uniform(int seed, int t, int id,
                                                int it) {
  return krng::uniform01<float>(krng::bounce_word(
      (uint32_t)seed, (uint32_t)t, (uint32_t)id, (uint32_t)it));
}

}  // namespace

// Scalars of one epoch launch that stay fixed over a window; mirrors the
// ctypes Structure in engine/fused_kernel.py field for field. The ones that
// change from epoch to epoch (seed, t_base, n_valid) are read from device
// memory instead, so a captured CUDA graph can replay the launch while the
// fused window (engine/fused.py) advances them on the device.
struct EpochParams {
  int n;         // spins
  int J;         // epoch steps (<= kMaxJ)
  int max_iter;  // bounce-pass budget per step
  float eps;     // surface offset after a collision (step lengths)
  float dil[kMaxJ];        // dilation ladder the table was packed with
  float fine[kNumFine];    // FINE_LADDER
};

template <bool kCount>
__global__ void __launch_bounds__(kThreads)
fused_epoch_kernel(const float* __restrict__ pos,      // (3, n)
                   const float* __restrict__ dirs,     // (J, 3, n)
                   const int* __restrict__ ids,        // (n,)
                   const int* __restrict__ start,      // (n,)
                   const int* __restrict__ packed,     // (n,)
                   const int* __restrict__ packed2,    // (n,)
                   const float* __restrict__ corner,   // (3, n)
                   const float* __restrict__ table,    // (units, 8, 4, 8, 4)
                   const float* __restrict__ sv_width, // (3,)
                   const float* __restrict__ perm_ptr, // ()
                   float* __restrict__ out_pos,        // (J, 3, n)
                   int* __restrict__ out_cross,        // (J, n)
                   bool* __restrict__ out_exc,         // (n,)
                   int* __restrict__ out_units,        // (n,), kCount only
                   int* __restrict__ out_passes,       // (n,), kCount only
                   int* __restrict__ out_issued,       // (ceil(n / 4),)
                   const int* __restrict__ seed_p,     // () RNG key
                   const int* __restrict__ t_base_p,   // () first step
                   const int* __restrict__ n_valid_p,  // () steps in window
                   EpochParams p) {
  const int i = blockIdx.x * (kThreads / kLanes) + threadIdx.x / kLanes;
  // Lanes of the warp with a spin: a prefix of the warp, since i grows
  // with the lane.
  unsigned live = 0u;
  if constexpr (kCount) live = __ballot_sync(0xffffffffu, i < p.n);
  if (i >= p.n) return;  // the whole group of the spin returns together
  const int r = threadIdx.x % kLanes;  // this lane's sublane
  const unsigned group = ((1u << kLanes) - 1u)
                         << (threadIdx.x & 31 & ~(kLanes - 1));
  const int n = p.n;
  float x = pos[i], y = pos[n + i], z = pos[2 * n + i];
  const float cx = corner[i], cy = corner[n + i], cz = corner[2 * n + i];
  const float wx = sv_width[0], wy = sv_width[1], wz = sv_width[2];
  const float perm = *perm_ptr;
  const int id = ids[i];
  const int row = start[i];
  const int pk = packed[i];
  const int pk2 = packed2[i];
  bool exc = false;
  int units = 0, passes = 0, issued = 0;  // kCount only

  for (int s = 0; s < p.J; ++s) {
    int crossings = 0;
    // The step scalars are read where they are used, one cached load that
    // all threads share: read once at the top instead, they left the
    // default variant 56 registers and 30 bytes of spills (ptxas, sm_90a).
    if (s < __ldg(n_valid_p)) {
      float dx = dirs[(3 * s) * n + i];
      float dy = dirs[(3 * s + 1) * n + i];
      float dz = dirs[(3 * s + 2) * n + i];
      float rem = 1.0f;
      int iters = 1;
      bool active = true;
      for (int it = 0;; ++it) {
        unsigned busy = 0u;  // lanes whose spin runs this pass (kCount)
        if constexpr (kCount) {
          busy = __ballot_sync(live, active);
          if (busy == 0u) break;
          if (!active) continue;
        } else {
          if (!active) break;
        }
        // Cell-local frame, fold cross products, runtime prefix level.
        const float xq = x - cx, yq = y - cy, zq = z - cz;
        const float ccx = yq * dz - zq * dy;
        const float ccy = zq * dx - xq * dz;
        const float ccz = xq * dy - yq * dx;
        const float ex = fmaxf(fmaxf(-xq, xq - wx), 0.0f);
        const float ey = fmaxf(fmaxf(-yq, yq - wy), 0.0f);
        const float ez = fmaxf(fmaxf(-zq, zq - wz), 0.0f);
        const float req = sqrtf(ex * ex + ey * ey + ez * ez) + rem + kReqMargin;
        int lvl = 0;
        for (int k = 0; k < kNumFine; ++k) lvl += (p.fine[k] < req);
        for (int l = 0; l < s; ++l) lvl += (p.dil[l] < req);
        const int cnt = lvl < kNumFine
                            ? (pk2 >> (kBits * lvl)) & kMask6
                            : (pk >> (kBits * (lvl - kNumFine))) & kMask6;
        if constexpr (kCount) {
          units += cnt;
          ++passes;
          // The warp's lane-groups fold the largest prefix of this pass;
          // its lowest busy lane books it.
          const int most = __reduce_max_sync(busy, cnt);
          if ((threadIdx.x & 31) == __ffs(busy) - 1) issued += most;
        }

        // Fold: nearest forward hit; equal t resolves to the lowest
        // sublane r, then to the earliest (unit, group) — the TPU order.
        // This lane folds sublane r of every (unit, group).
        float best = CUDART_INF_F, bnx = 0.0f, bny = 0.0f, bnz = 0.0f;
        int best_r = 8;
        for (int c = 0; c < cnt; ++c) {
          // Quad q of triangle (g, r) is float4 (4g + q) * 8 + r of the
          // unit, so the group's eight loads are 128 contiguous bytes.
          const float4* sub =
              reinterpret_cast<const float4*>(table + (size_t)(row + c) * 1024)
              + r;
#pragma unroll
          for (int g = 0; g < 8; ++g) {
            const float4* f4 = sub + 32 * g;
            const float4 a = __ldg(f4), b = __ldg(f4 + 8);
            const float4 c4 = __ldg(f4 + 16), d = __ldg(f4 + 24);
            const float det = -(dx * a.x + dy * a.y + dz * a.z);
            const float tn = (xq * a.x + yq * a.y + zq * a.z) - a.w;
            const float un = (ccx * b.x + ccy * b.y + ccz * b.z) -
                             (dx * b.w + dy * c4.x + dz * c4.y);
            const float vn = -(ccx * c4.z + ccy * c4.w + ccz * d.x) -
                             (dx * d.y + dy * d.z + dz * d.w);
            const float inv = 1.0f / det;
            const float t = tn * inv;
            const float u = un * inv;
            const float v = vn * inv;
            const bool ok = (det != 0.0f) && (u >= -kEdgeTol) &&
                            (u <= 1.0f + kEdgeTol) && (v >= -kEdgeTol) &&
                            (u + v <= 1.0f + kEdgeTol) && (t > 0.0f);
            if (ok && (t < best || (t == best && r < best_r))) {
              best = t;
              best_r = r;
              bnx = a.x;
              bny = a.y;
              bnz = a.z;
            }
          }
        }
        // The group's lexicographic minimum of (t, r), in all its lanes.
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1) {
          const float t_o = __shfl_xor_sync(group, best, off, kLanes);
          const int r_o = __shfl_xor_sync(group, best_r, off, kLanes);
          const float x_o = __shfl_xor_sync(group, bnx, off, kLanes);
          const float y_o = __shfl_xor_sync(group, bny, off, kLanes);
          const float z_o = __shfl_xor_sync(group, bnz, off, kLanes);
          if (t_o < best || (t_o == best && r_o < best_r)) {
            best = t_o;
            best_r = r_o;
            bnx = x_o;
            bny = y_o;
            bnz = z_o;
          }
        }

        // Resolve: accept, then reflect or cross, offset, consume.
        const bool hit = best <= rem + kSlack;
        active = false;
        if (hit) {
          const float rn =
              rsqrtf(fmaxf(bnx * bnx + bny * bny + bnz * bnz, 1e-30f));
          const float nx = bnx * rn, ny = bny * rn, nz = bnz * rn;
          const float u_go =
              perm > 0.0f ? bounce_uniform(__ldg(seed_p), __ldg(t_base_p) + s,
                                          id, it)
                          : 1.0f;
          const bool go = u_go < perm;
          crossings += go;
          const float vx = best * dx, vy = best * dy, vz = best * dz;
          const float dp = vx * nx + vy * ny + vz * nz;
          const float flip = dp > 0.0f ? -1.0f : 1.0f;
          const float nrx = nx * flip, nry = ny * flip, nrz = nz * flip;
          const float dp_o = -fabsf(dp);
          float ndx = vx - 2.0f * dp_o * nrx;
          float ndy = vy - 2.0f * dp_o * nry;
          float ndz = vz - 2.0f * dp_o * nrz;
          const float nd_rn = rsqrtf(ndx * ndx + ndy * ndy + ndz * ndz);
          ndx *= nd_rn;
          ndy *= nd_rn;
          ndz *= nd_rn;
          const float ofs = go ? -p.eps : p.eps;
          x = x + vx + ofs * nrx;
          y = y + vy + ofs * nry;
          z = z + vz + ofs * nrz;
          if (!go) {
            dx = ndx;
            dy = ndy;
            dz = ndz;
          }
          rem = rem - best;
          active = rem > 0.0f && iters < p.max_iter;
          if (active) ++iters;
        }
      }
      // The settled spin advances by its remaining segment.
      x = x + dx * rem;
      y = y + dy * rem;
      z = z + dz * rem;
      exc = exc || iters >= p.max_iter;
    }
    if (r == 0) {
      out_pos[(3 * s) * n + i] = x;
      out_pos[(3 * s + 1) * n + i] = y;
      out_pos[(3 * s + 2) * n + i] = z;
      out_cross[s * n + i] = crossings;
    }
  }
  if (r == 0) out_exc[i] = exc;
  if constexpr (kCount) {
    if (r == 0) {
      out_units[i] = units;
      out_passes[i] = passes;
    }
    issued = __reduce_add_sync(live, issued);
    if ((threadIdx.x & 31) == 0)
      out_issued[(blockIdx.x * kThreads + threadIdx.x) / 32] =
          kSpinsPerWarp * issued;
  }
}

__global__ void threefry_kernel(const int* __restrict__ x0,
                                const int* __restrict__ x1, int k0, int k1,
                                int rounds, int n, int* __restrict__ o0,
                                int* __restrict__ o1) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t w0, w1;
  krng::threefry2x32((uint32_t)k0, (uint32_t)k1, (uint32_t)x0[i],
                     (uint32_t)x1[i], rounds, &w0, &w1);
  o0[i] = (int)w0;
  o1[i] = (int)w1;
}

extern "C" {

// out_units, out_passes and out_issued are null for the default variant;
// given, they select the counting variant. seed, t_base and n_valid point
// to one int32 each on the device.
int fused_epoch_launch(const void* pos, const void* dirs, const void* ids,
                       const void* start, const void* packed,
                       const void* packed2, const void* corner,
                       const void* table, const void* sv_width,
                       const void* perm, void* out_pos, void* out_cross,
                       void* out_exc, void* out_units, void* out_passes,
                       void* out_issued, const void* seed,
                       const void* t_base, const void* n_valid, EpochParams p,
                       void* stream) {
  if (p.n > 0) {
    const int spins = kThreads / kLanes;  // per block
    const int blocks = (p.n + spins - 1) / spins;
    auto kernel = out_units ? fused_epoch_kernel<true>
                            : fused_epoch_kernel<false>;
    kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)pos, (const float*)dirs, (const int*)ids,
        (const int*)start, (const int*)packed, (const int*)packed2,
        (const float*)corner, (const float*)table, (const float*)sv_width,
        (const float*)perm, (float*)out_pos, (int*)out_cross,
        (bool*)out_exc, (int*)out_units, (int*)out_passes, (int*)out_issued,
        (const int*)seed, (const int*)t_base, (const int*)n_valid, p);
  }
  return (int)cudaGetLastError();
}

// Device threefry words for (key, counter) pairs; used to check the device
// cipher against engine/krng.py bit for bit.
int threefry2x32_launch(const void* x0, const void* x1, int k0, int k1,
                        int rounds, int n, void* o0, void* o1, void* stream) {
  if (n > 0) {
    const int threads = 256;
    threefry_kernel<<<(n + threads - 1) / threads, threads, 0,
                      (cudaStream_t)stream>>>((const int*)x0, (const int*)x1,
                                              k0, k1, rounds, n, (int*)o0,
                                              (int*)o1);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
