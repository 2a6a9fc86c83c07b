// Nearest forward triangle hit per spin in its halo cell, one thread per
// spin.
//
// Replaces disimpy_tpu/engine/pallas_mesh.py:119 (_kernel, launched by
// _run_query, wrapped by nearest_hit_pallas): the classic mesh engine's
// collision query on the halo layout of engine/mesh_accel.pack_mesh. For
// each spin: the cell holding the minimum corner of the segment's bounding
// box, floor(min(r0, r0 + dir * rem) / sv_width), wrapped into the voxel
// with the whole-voxel shift applied to r0; then Moller-Trumbore against
// the cell's first cell_counts[cell] records (EDGE_TOL band on u, v and
// u + v, det != 0, t > 0), keeping the closest t with a strict < in record
// order, so ties go to the lowest record. Output: min_d (inf where nothing
// is hit) and the hit triangle's unoriented unit normal (zero where
// nothing is hit).
//
// The TPU kernel sorted the spins by cell, streamed each cell's row into
// VMEM once per run of spins, and sorted the results back, because a TPU
// gather runs on the scalar core (pallas_mesh.py:3-6). On the GPU each
// thread reads its own row: no sorts, no transposed table.
//
// What bounds it on the H100: floating-point issue rate. A spin tests
// about 180 records (the bench bundle) at about 50 operations each, and
// each record is 48 bytes (float) that neighbouring spins of the same
// cell also read, so the table's bytes are mostly served from L2. Warp
// divergence adds to it: a warp runs as long as its spin with the longest
// row. This version does nothing about either; sorting spins by cell and
// staging a cell's row in shared memory per block, as the TPU design did
// with VMEM, is the next step.
//
// The arithmetic follows _mt_block's order (inv_det = 1 / det, then t, u
// and v as products with it), so the kernel and the plain torch version
// differ only by nvcc's FMA contraction.
//
// C interface (bound with ctypes): each entry point returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

__device__ __forceinline__ float inf_of(float) { return CUDART_INF_F; }
__device__ __forceinline__ double inf_of(double) { return CUDART_INF; }

// Floor division by a positive divisor.
__device__ __forceinline__ int floor_div(int a, int m) {
  return a >= 0 ? a / m : -((-a + m - 1) / m);
}

template <typename T>
__global__ void __launch_bounds__(256) mesh_hit_kernel(
    const T* __restrict__ r0, const T* __restrict__ dir,
    const T* __restrict__ rem, const T* __restrict__ tri,
    const int* __restrict__ counts, const T* __restrict__ sv_width,
    const T* __restrict__ voxel, int n, int n0, int n1, int n2, int k_pad,
    T edge_tol, T* __restrict__ out_d, T* __restrict__ out_n) {
  const int nsv[3] = {n0, n1, n2};
  const T lo_tol = -edge_tol;
  const T hi_tol = T(1) + edge_tol;
  const T inf = inf_of(T(0));
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    T d[3], s[3];
    int c[3];
    const T rm = rem[i];
    for (int a = 0; a < 3; ++a) {
      const T p = r0[3 * i + a];
      d[a] = dir[3 * i + a];
      const T e = p + d[a] * rm;
      const T lo = e < p ? e : p;
      const int base = (int)floor(lo / sv_width[a]);
      const int shift = floor_div(base, nsv[a]);
      c[a] = base - shift * nsv[a];
      s[a] = p - (T)shift * voxel[a];
    }
    const int cell = (c[0] * n1 + c[1]) * n2 + c[2];
    const int cnt = counts[cell];
    const T* row = tri + (size_t)cell * k_pad * 12;
    T best = inf;
    int best_k = -1;
    for (int k = 0; k < cnt; ++k) {
      const T* q = row + 12 * k;
      const T ax = q[0], ay = q[1], az = q[2];
      const T e1x = q[3] - ax, e1y = q[4] - ay, e1z = q[5] - az;
      const T e2x = q[6] - ax, e2y = q[7] - ay, e2z = q[8] - az;
      const T tx = s[0] - ax, ty = s[1] - ay, tz = s[2] - az;
      // P = dir x E2, Q = T x E1.
      const T px = d[1] * e2z - d[2] * e2y;
      const T py = d[2] * e2x - d[0] * e2z;
      const T pz = d[0] * e2y - d[1] * e2x;
      const T qx = ty * e1z - tz * e1y;
      const T qy = tz * e1x - tx * e1z;
      const T qz = tx * e1y - ty * e1x;
      const T det = px * e1x + py * e1y + pz * e1z;
      const T inv_det = T(1) / det;
      const T t = inv_det * (qx * e2x + qy * e2y + qz * e2z);
      const T u = inv_det * (px * tx + py * ty + pz * tz);
      const T v = inv_det * (qx * d[0] + qy * d[1] + qz * d[2]);
      const bool ok = det != T(0) && u >= lo_tol && u <= hi_tol &&
                      v >= lo_tol && v <= hi_tol && u + v <= hi_tol &&
                      t > T(0);
      if (ok && t < best) {
        best = t;
        best_k = k;
      }
    }
    out_d[i] = best;
    for (int a = 0; a < 3; ++a) {
      out_n[3 * i + a] = best_k >= 0 ? row[12 * best_k + 9 + a] : T(0);
    }
  }
}

template <typename T>
int launch(const void* r0, const void* dir, const void* rem, const void* tri,
           const void* counts, const void* sv_width, const void* voxel, int n,
           int n0, int n1, int n2, int k_pad, T edge_tol, void* out_d,
           void* out_n, void* stream) {
  const int threads = 256;
  long long want = ((long long)n + threads - 1) / threads;
  const int blocks = (int)(want < (1 << 20) ? want : (1 << 20));
  mesh_hit_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)r0, (const T*)dir, (const T*)rem, (const T*)tri,
      (const int*)counts, (const T*)sv_width, (const T*)voxel, n, n0, n1, n2,
      k_pad, edge_tol, (T*)out_d, (T*)out_n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int mesh_hit_launch_f32(const void* r0, const void* dir, const void* rem,
                        const void* tri, const void* counts,
                        const void* sv_width, const void* voxel, int n, int n0,
                        int n1, int n2, int k_pad, float edge_tol, void* out_d,
                        void* out_n, void* stream) {
  return launch<float>(r0, dir, rem, tri, counts, sv_width, voxel, n, n0, n1,
                       n2, k_pad, edge_tol, out_d, out_n, stream);
}

int mesh_hit_launch_f64(const void* r0, const void* dir, const void* rem,
                        const void* tri, const void* counts,
                        const void* sv_width, const void* voxel, int n, int n0,
                        int n1, int n2, int k_pad, double edge_tol,
                        void* out_d, void* out_n, void* stream) {
  return launch<double>(r0, dir, rem, tri, counts, sv_width, voxel, n, n0, n1,
                        n2, k_pad, edge_tol, out_d, out_n, stream);
}

}  // extern "C"
