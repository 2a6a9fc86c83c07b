// Nearest forward triangle hit per spin in its halo cell: spins grouped
// by cell into tiles, each tile's row staged in shared memory.
//
// Replaces disimpy_tpu/engine/pallas_mesh.py:119 (_kernel, launched by
// _run_query, wrapped by nearest_hit_pallas): the classic mesh engine's
// collision query on the halo layout of engine/mesh_accel.pack_mesh. For
// each spin: the cell holding the minimum corner of the segment's bounding
// box, floor(min(r0, r0 + dir * rem) / sv_width), wrapped into the voxel
// with the whole-voxel shift applied to r0; then Moller-Trumbore against
// the cell's first cell_counts[cell] records (EDGE_TOL band on u, v and
// u + v, det != 0, t > 0), keeping the closest t, ties to the lowest
// record. Output: min_d (inf where nothing is hit) and the hit triangle's
// unoriented unit normal (zero where nothing is hit).
//
// What bounds it on the H100: the floating-point issue rate of the
// record tests (about 180 records per spin on the bench bundle, ~50
// operations each). The row data is small and shared: a cell's row
// (up to ~320 records of 48 or 96 bytes) serves every spin of that cell.
// Taken one thread per spin in caller order, a warp ran as long as its
// longest row, its lanes read 32 different rows through L2, and the
// engine's compacted bounce passes (at most n / 8 spins) left the card
// latency-bound.
//
// The design, one query = a memset and four kernels on the caller's
// stream, no host sync:
//   1. cell pass: each spin's halo cell; per-cell counts by atomics, and
//      each spin's rank within its cell;
//   2. scan (one block): cell offsets, and the tiles: runs of at most
//      kTile spins of one cell;
//   3. scatter: spin indices in cell order;
//   4. hit pass: one block per tile. The cell's row streams through shared
//      memory in stages of the pack's chunk (cp.async, 16-byte copies,
//      double-buffered) and is stored as (A, E1, E2, normal) columns, so
//      E1 and E2 are formed once per record (the same subtractions, so the
//      same bits) and the lanes read it by broadcast or on distinct banks.
//      The block's kTile threads are split among the tile's s spins: L =
//      min(32, kTile / s rounded down to a power of two) lanes per spin.
//      Lane j tests records j, j + L, ... keeping its first minimum with a
//      strict <, and the L lanes reduce by (t, record) lexicographically,
//      so equal distances still resolve to the lowest record. A dense tile
//      (the full batch: ~76 spins per occupied cell) runs one lane per
//      spin; a sparse bounce pass gets up to 32 lanes per spin.
//   5. lane 0 of each spin writes its result at the spin's own index.
//
// K9, the classic mesh step on the card (mesh_step_launch_*): the JAX
// package's step_mesh while-loop (disimpy_tpu/engine/stepping.py:262-341),
// whose later passes call K2 on the compacted subset under lax.while_loop,
// as one fixed stream of kernels with no host sync:
//   a. the first bounce pass is the query above on the whole batch, with
//      an epilogue in the hit pass: lane 0 of each spin resolves its hit
//      (stepping._resolve_mesh_hits: the bounce-0 uniform drawn in-kernel,
//      reflect or cross, rem -= d), sets iters = 1 and appends the spin to
//      a device worklist if it still collides;
//   b. the second check, grouped by cell as the first: relist_cells,
//      relist_scan and relist_scatter (K2's cell, scan and scatter logic
//      over the worklist, its length read on the device) sort the listed
//      spins by the halo cell of their next segment into tiles, and
//      later_pass stages each tile's row in shared memory as the hit pass
//      does and resolves the check (lane 0 of each spin: the uniform of
//      bounce index iters - 1, drawn once); a spin that still collides goes
//      to a second, short list;
//   c. bounce_pass (the remainder): a fixed grid of blocks walks the second
//      list, one warp per spin, and loops that spin's later bounces to the
//      end of its step, reading its rows from global memory;
//   d. finish_pass writes r0 + dir * rem and iters >= max_iter.
// Why sorted and not in the hit pass's order: a bounce moves the segment's
// bounding box, so a spin's next halo cell need not be the first pass's;
// sorting tests every listed spin against its own row, with no fallback,
// with the first pass's own cell, scan and scatter logic.
// What bounds it on the H100 (measured on an NVIDIA H100 80GB HBM3 at 700
// W, float32 bench bundle step, 63,290 listed spins): K9 as first written
// (commit 9f0b714) ran every later check as one warp reading its spin's
// row (~178 records) from L2 or HBM in worklist order, 0.160 ms. Staged
// by cell, the second checks read ~57 MB of rows once, but later_pass
// still takes ~0.07 ms (0.105 in float64): it is held by the record tests
// of sparse tiles (~9 spins per row, 11.8 million tests, two thirds of
// the hit pass's rate), not by the rows' bytes. A persistent grid, capped
// sort grids and a non-power-of-two lane split did not beat this kernel;
// 96-record stages (all of a typical row in flight at once) beat the
// pack's 46-record chunks (sort and staged pass 0.094 ms against 0.100).
// The sort takes ~0.022 ms (its one-block scan 0.013), the remainder
// 0.02-0.04 ms (the longest spin's chain of up to 17 checks) and the tail
// 0.007 ms. Bound: 0.025 ms (bytes: the rows the later checks read, once,
// and the spins' state).

// The record test keeps _mt_block's order (inv_det = 1 / det, then t, u
// and v as products with it), so the kernel and the plain torch version
// differ only by nvcc's FMA contraction.
//
// The resolves follow the plain version's torch operators one IEEE
// operation each (krng::mul_rn and friends, csrc/threefry.cuh), so K9 and
// the plain loop differ only where K2 and the plain query do.
//
// C interface (bound with ctypes): mesh_hit_scratch_words and
// mesh_step_scratch_words give the int32 scratch a query or a step needs;
// each launch entry point returns the first CUDA error of its launches (0
// on success).

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

constexpr int kTile = 128;   // threads of a hit block; most spins per tile
constexpr int kStage = 64;   // most records staged at once
constexpr int kLaterStage = 96;  // most records later_pass stages at once
constexpr int kScan = 1024;  // threads of the one-block scan
constexpr int kBounce = 256;  // threads of a remainder block: eight warps

__device__ __forceinline__ float inf_of(float) { return CUDART_INF_F; }
__device__ __forceinline__ double inf_of(double) { return CUDART_INF; }
// stepping._hit_slack.
__device__ __forceinline__ float slack_of(float) { return 1e-5f; }
__device__ __forceinline__ double slack_of(double) { return 1e-12; }

// A classic mesh step's per-spin state after its first bounce pass, which
// K9 carries to the end of the step, and what the resolves read.
template <typename T>
struct StepState {
  T* r0;                    // (n, 3)
  T* dir;                   // (n, 3)
  T* rem;                   // (n,)
  int* iters;               // (n,) collision checks so far
  int* crossings;           // (n,) membrane transits
  int* list;                // spins still colliding after the first pass
  int* n_list;              // () their count
  int* rest;                // spins still colliding after the second check
  int* n_rest;              // () their count
  const int* ids;           // (n,) spin ids keying the draws
  const int* seed;          // () RNG key
  const int* t;             // () step
  const T* perm;            // () perm_prob
  const T* eps;             // () epsilon
  int max_iter;
};

// Floor division by a positive divisor.
__device__ __forceinline__ int floor_div(int a, int m) {
  return a >= 0 ? a / m : -((-a + m - 1) / m);
}

// The halo cell of the segment p + [0, rm] * d; s gets p shifted by the
// same whole voxels.
template <typename T>
__device__ __forceinline__ int halo_cell_of(const T p[3], const T d[3], T rm,
                                            const T* __restrict__ sv_width,
                                            const T* __restrict__ voxel,
                                            const int nsv[3], T s[3]) {
  int c[3];
  for (int a = 0; a < 3; ++a) {
    const T e = p[a] + d[a] * rm;
    const T lo = e < p[a] ? e : p[a];
    const int base = (int)floor(lo / sv_width[a]);
    const int shift = floor_div(base, nsv[a]);
    c[a] = base - shift * nsv[a];
    s[a] = p[a] - (T)shift * voxel[a];
  }
  return (c[0] * nsv[1] + c[1]) * nsv[2] + c[2];
}

// Spin i's halo cell; s gets r0 shifted by the same whole voxels and d the
// direction.
template <typename T>
__device__ __forceinline__ int halo_cell(const T* __restrict__ r0,
                                         const T* __restrict__ dir,
                                         const T* __restrict__ rem, int i,
                                         const T* __restrict__ sv_width,
                                         const T* __restrict__ voxel,
                                         const int nsv[3], T s[3], T d[3]) {
  T p[3];
  for (int a = 0; a < 3; ++a) {
    p[a] = r0[3 * i + a];
    d[a] = dir[3 * i + a];
  }
  return halo_cell_of(p, d, rem[i], sv_width, voxel, nsv, s);
}

// One record's Moller-Trumbore test (_mt_block's order: inv_det = 1 / det,
// then t, u and v as products with it) of the ray s + t d against the
// triangle with corner A = c[0..2] and edges E1 = c[3..5], E2 = c[6..8]:
// true with t where the ray crosses the triangle within the EDGE_TOL band
// strictly forward. K2's hit pass and K9 share it, so both test a record
// to the same bits.
template <typename T>
__device__ __forceinline__ bool record_test(const T s[3], const T d[3],
                                            const T c[9], T lo_tol, T hi_tol,
                                            T* t_out) {
  const T ax = c[0], ay = c[1], az = c[2];
  const T e1x = c[3], e1y = c[4], e1z = c[5];
  const T e2x = c[6], e2y = c[7], e2z = c[8];
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
  *t_out = t;
  return det != T(0) && u >= lo_tol && u <= hi_tol && v >= lo_tol &&
         v <= hi_tol && u + v <= hi_tol && t > T(0);
}

template <typename T>
__global__ void __launch_bounds__(256) cell_pass(
    const T* __restrict__ r0, const T* __restrict__ dir,
    const T* __restrict__ rem, const T* __restrict__ sv_width,
    const T* __restrict__ voxel, int n, int n0, int n1, int n2,
    int* __restrict__ fill, int* __restrict__ cell_of,
    int* __restrict__ rank_of) {
  const int nsv[3] = {n0, n1, n2};
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    T s[3], d[3];
    const int cell = halo_cell(r0, dir, rem, i, sv_width, voxel, nsv, s, d);
    cell_of[i] = cell;
    rank_of[i] = atomicAdd(fill + cell, 1);
  }
}

// One block: exclusive scans of the per-cell spin counts and tile counts,
// then each cell's tiles as (cell, first sorted position, spins).
__device__ __forceinline__ void scan_cells(const int* __restrict__ fill,
                                           int n_cells,
                                           int* __restrict__ start,
                                           int4* __restrict__ tiles,
                                           int* __restrict__ n_tiles) {
  __shared__ int sa[kScan], sb[kScan];
  const int tid = threadIdx.x;
  const int per = (n_cells + kScan - 1) / kScan;
  const int lo = min(tid * per, n_cells);
  const int hi = min(lo + per, n_cells);
  int a = 0, b = 0;
  for (int c = lo; c < hi; ++c) {
    a += fill[c];
    b += (fill[c] + kTile - 1) / kTile;
  }
  sa[tid] = a;
  sb[tid] = b;
  __syncthreads();
  for (int off = 1; off < kScan; off <<= 1) {
    const int x = tid >= off ? sa[tid - off] : 0;
    const int y = tid >= off ? sb[tid - off] : 0;
    __syncthreads();
    sa[tid] += x;
    sb[tid] += y;
    __syncthreads();
  }
  int pos = sa[tid] - a, tile = sb[tid] - b;
  for (int c = lo; c < hi; ++c) {
    const int cnt = fill[c];
    start[c] = pos;
    for (int q = 0; q < cnt; q += kTile) {
      tiles[tile++] = make_int4(c, pos + q, min(kTile, cnt - q), 0);
    }
    pos += cnt;
  }
  if (tid == kScan - 1) *n_tiles = sb[kScan - 1];
}

__global__ void __launch_bounds__(kScan) scan_pass(
    const int* __restrict__ fill, int n_cells, int* __restrict__ start,
    int4* __restrict__ tiles, int* __restrict__ n_tiles) {
  scan_cells(fill, n_cells, start, tiles, n_tiles);
}

__global__ void __launch_bounds__(256) scatter_pass(
    const int* __restrict__ cell_of, const int* __restrict__ rank_of,
    const int* __restrict__ start, int n, int* __restrict__ perm) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    perm[start[cell_of[i]] + rank_of[i]] = i;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// torch.sum over the last axis of an (n, 3) tensor, as the plain
// version's geometry.normalize takes it: stored spins-fastest (the first
// bounce pass's rows, strides (1, n)) the three values are summed in
// order; stored contiguous (the compacted passes' gathered rows) torch's
// CUDA reduction splits them over two lanes, (a0 + a2) + a1. Both orders
// are torch's internals, found by probing torch 2.11.0+cu128 on an H100;
// phase 19 of chip_smoke.py holds the mesh step to the plain loop bit for
// bit, so a torch that sums in another order fails it.
template <typename T, bool kGathered>
__device__ __forceinline__ T sum3_last(T a0, T a1, T a2) {
  return kGathered ? add_rn(add_rn(a0, a2), a1) : add_rn(add_rn(a0, a1), a2);
}

// stepping._resolve_mesh_hits for one spin with a hit at distance d on a
// triangle of unit normal nrm (either orientation): cross epsilon past the
// wall keeping the direction, or reflect (geometry.crossing /
// geometry.reflect), then rem -= d. One IEEE operation per torch operator,
// with no FMA contraction.
template <typename T, bool kGathered>
__device__ __forceinline__ void resolve_hit(T p[3], T dd[3], T& rm, T d,
                                            const T nrm[3], bool through,
                                            T eps) {
  T v[3];
  for (int a = 0; a < 3; ++a) v[a] = mul_rn(d, dd[a]);
  const T dp = add_rn(add_rn(mul_rn(v[0], nrm[0]), mul_rn(v[1], nrm[1])),
                      mul_rn(v[2], nrm[2]));
  if (through) {
    const T sgn = dp < T(0) ? T(-1) : T(1);
    for (int a = 0; a < 3; ++a) {
      p[a] = add_rn(add_rn(p[a], v[a]), mul_rn(eps, sgn * nrm[a]));
    }
  } else {
    const T sgn = dp > T(0) ? T(-1) : T(1);
    const T two_dp = mul_rn(T(2), -fabs(dp));
    T w[3];
    for (int a = 0; a < 3; ++a) {
      const T na = sgn * nrm[a];
      p[a] = add_rn(add_rn(p[a], v[a]), mul_rn(eps, na));
      w[a] = sub_rn(v[a], mul_rn(two_dp, na));
    }
    const T norm = sqrt_rn(sum3_last<T, kGathered>(
        mul_rn(w[0], w[0]), mul_rn(w[1], w[1]), mul_rn(w[2], w[2])));
    for (int a = 0; a < 3; ++a) dd[a] = div_rn(w[a], norm);
  }
  rm = sub_rn(rm, d);
}

// The lexicographic minimum of (t, record) over the L aligned lanes of a
// warp, left in every one of them.
template <typename T>
__device__ __forceinline__ void min_butterfly(T& best, int& best_k, int L) {
  for (int off = L >> 1; off > 0; off >>= 1) {
    const T t_o = __shfl_xor_sync(0xffffffffu, best, off);
    const int k_o = __shfl_xor_sync(0xffffffffu, best_k, off);
    if (t_o < best || (t_o == best && k_o < best_k)) {
      best = t_o;
      best_k = k_o;
    }
  }
}

// A tile's shared memory: the raw records as they arrive (double-buffered)
// and the staged columns A (0-2), E1 (3-5), E2 (6-8), normal (9-11).
template <typename T, int kCap>
struct __align__(16) TileRows {
  T raw[2][kCap * 12];
  T col[12][kCap];
};

// The nearest hit of a tile's spins in one row: the row (cnt records)
// streams through shared memory in stages of `stage` records (cp.async,
// 16-byte copies, double-buffered) and is stored as (A, E1, E2, normal)
// columns; lane `lane` of a live spin's L lanes tests records lane, lane +
// L, ... keeping its first minimum, and the L lanes reduce by (t, record).
// Every thread of the block calls it; best and best_k end up in every lane
// of a live spin (inf and -1 where nothing is hit).
template <typename T, int kCap>
__device__ __forceinline__ void tile_nearest(
    TileRows<T, kCap>& sm, const T* __restrict__ row, int cnt, int stage,
    bool live, int L, int lane, const T s[3], const T d[3], T edge_tol,
    T& best, int& best_k) {
  const T lo_tol = -edge_tol;
  const T hi_tol = T(1) + edge_tol;
  const int n_stages = (cnt + stage - 1) / stage;
  constexpr int kPieces = 12 * sizeof(T) / 16;  // 16-byte copies per record

  auto issue = [&](int st) {
    if (st < n_stages) {
      const int k0 = st * stage;
      const int pieces = min(stage, cnt - k0) * kPieces;
      const char* src = reinterpret_cast<const char*>(row + 12 * k0);
      char* dst = reinterpret_cast<char*>(sm.raw[st & 1]);
      for (int p = threadIdx.x; p < pieces; p += kTile) {
        cp_async16(dst + 16 * p, src + 16 * p);
      }
    }
    cp_async_commit();  // empty groups keep the count uniform
  };

  best = inf_of(T(0));
  best_k = -1;
  issue(0);
  issue(1);
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait_one();
    __syncthreads();  // stage st has landed; col is free
    const int k0 = st * stage;
    const int nrec = min(stage, cnt - k0);
    for (int k = threadIdx.x; k < nrec; k += kTile) {
      const T* q = sm.raw[st & 1] + 12 * k;
      const T ax = q[0], ay = q[1], az = q[2];
      sm.col[0][k] = ax;
      sm.col[1][k] = ay;
      sm.col[2][k] = az;
      sm.col[3][k] = q[3] - ax;
      sm.col[4][k] = q[4] - ay;
      sm.col[5][k] = q[5] - az;
      sm.col[6][k] = q[6] - ax;
      sm.col[7][k] = q[7] - ay;
      sm.col[8][k] = q[8] - az;
      sm.col[9][k] = q[9];
      sm.col[10][k] = q[10];
      sm.col[11][k] = q[11];
    }
    __syncthreads();  // col holds stage st; raw[st & 1] is free
    issue(st + 2);
    if (live) {
      for (int kl = (lane - k0) & (L - 1); kl < nrec; kl += L) {
        T c[9];
        for (int q = 0; q < 9; ++q) c[q] = sm.col[q][kl];
        T t;
        if (record_test(s, d, c, lo_tol, hi_tol, &t) && t < best) {
          best = t;
          best_k = k0 + kl;
        }
      }
    }
  }
  // The spin's L lanes are aligned within a warp: a butterfly leaves the
  // lexicographic minimum of (t, record) in every lane.
  min_butterfly(best, best_k, L);
}

// Lanes per spin of a tile of s spins: the largest power of two up to 32
// with L s <= kTile.
__device__ __forceinline__ int lanes_per_spin(int s) {
  int L = 1;
  while (L < 32 && 2 * L * s <= kTile) L *= 2;
  return L;
}

// kResolve (the classic step's first pass): instead of writing min_d and
// the normal, lane 0 of each spin resolves the hit into st (the bounce-0
// uniform drawn here) and lists the spin for the later passes if it still
// collides.
template <typename T, bool kResolve>
__global__ void __launch_bounds__(kTile) hit_pass(
    const T* __restrict__ r0, const T* __restrict__ dir,
    const T* __restrict__ rem, const T* __restrict__ tri,
    const int* __restrict__ counts, const T* __restrict__ sv_width,
    const T* __restrict__ voxel, int n0, int n1, int n2, int k_pad,
    int stage, T edge_tol, const int* __restrict__ perm,
    const int4* __restrict__ tiles, const int* __restrict__ n_tiles,
    T* __restrict__ out_d, T* __restrict__ out_n, StepState<T> st) {
  __shared__ TileRows<T, kStage> sm;
  if ((int)blockIdx.x >= *n_tiles) return;
  const int4 tl = tiles[blockIdx.x];
  const int cell = tl.x, s_count = tl.z;
  const int L = lanes_per_spin(s_count);
  const int slot = threadIdx.x / L;
  const int lane = threadIdx.x & (L - 1);
  const bool live = slot < s_count;
  const int nsv[3] = {n0, n1, n2};
  T s[3] = {T(0), T(0), T(0)}, d[3] = {T(0), T(0), T(0)};
  int i = 0;
  if (live) {
    i = perm[tl.y + slot];
    halo_cell(r0, dir, rem, i, sv_width, voxel, nsv, s, d);
  }
  const T* row = tri + (size_t)cell * k_pad * 12;
  T best;
  int best_k;
  tile_nearest(sm, row, counts[cell], stage, live, L, lane, s, d, edge_tol,
               best, best_k);
  if (!live || lane != 0) return;
  if (!kResolve) {
    out_d[i] = best;
    for (int a = 0; a < 3; ++a) {
      out_n[3 * i + a] = best_k >= 0 ? row[12 * best_k + 9 + a] : T(0);
    }
    return;
  }
  // stepping.step_mesh's first pass for spin i: hit = d <= rem + slack,
  // collision check 1 draws at bounce index 0.
  T p[3], nrm[3];
  for (int a = 0; a < 3; ++a) {
    p[a] = r0[3 * i + a];
    nrm[a] = best_k >= 0 ? row[12 * best_k + 9 + a] : T(0);
  }
  T rm = rem[i];
  const bool hit = best <= add_rn(rm, slack_of(T(0)));
  int cross = 0;
  if (hit) {
    cross = krng::bounce_uniform<T>((uint32_t)__ldg(st.seed),
                                    (uint32_t)__ldg(st.t),
                                    (uint32_t)st.ids[i], 0u) < *st.perm;
    resolve_hit<T, false>(p, d, rm, best, nrm, cross, *st.eps);
  }
  for (int a = 0; a < 3; ++a) {
    st.r0[3 * i + a] = p[a];
    st.dir[3 * i + a] = d[a];
  }
  st.rem[i] = rm;
  st.iters[i] = 1;
  st.crossings[i] = cross;
  if (hit && rm > T(0) && 1 < st.max_iter) {
    st.list[atomicAdd(st.n_list, 1)] = i;
  }
}

// The listed spins in cell order for later_pass, as cell_pass, scan_pass
// and scatter_pass order the whole batch: the halo cell of each listed
// spin's next segment (from the state the first pass resolved) and its rank
// there, over a fixed grid that reads the list's length on the device.
template <typename T>
__global__ void __launch_bounds__(256) relist_cells(
    StepState<T> st, const T* __restrict__ sv_width,
    const T* __restrict__ voxel, int n0, int n1, int n2,
    int* __restrict__ fill, int* __restrict__ cell_of,
    int* __restrict__ rank_of) {
  const int nsv[3] = {n0, n1, n2};
  const int m = *st.n_list;
  for (int w = blockIdx.x * blockDim.x + threadIdx.x; w < m;
       w += gridDim.x * blockDim.x) {
    T s[3], d[3];
    const int cell = halo_cell<T>(st.r0, st.dir, st.rem, st.list[w],
                                  sv_width, voxel, nsv, s, d);
    cell_of[w] = cell;
    rank_of[w] = atomicAdd(fill + cell, 1);
  }
}

// scan_pass under its own name, so that a profile tells K9's sort from
// K2's.
__global__ void __launch_bounds__(kScan) relist_scan(
    const int* __restrict__ fill, int n_cells, int* __restrict__ start,
    int4* __restrict__ tiles, int* __restrict__ n_tiles) {
  scan_cells(fill, n_cells, start, tiles, n_tiles);
}

__global__ void __launch_bounds__(256) relist_scatter(
    const int* __restrict__ list, const int* __restrict__ n_list,
    const int* __restrict__ cell_of, const int* __restrict__ rank_of,
    const int* __restrict__ start, int* __restrict__ perm) {
  const int m = *n_list;
  for (int w = blockIdx.x * blockDim.x + threadIdx.x; w < m;
       w += gridDim.x * blockDim.x) {
    perm[start[cell_of[w]] + rank_of[w]] = list[w];
  }
}

// K9's second check (stepping.step_mesh's first compacted pass): one block
// per tile of listed spins that share the next segment's halo cell, the
// row staged once in shared memory (tile_nearest, as the hit pass), and
// lane 0 of each spin resolving its hit with the uniform of bounce index
// iters - 1 and the gathered rows' normalize order. A spin that still
// collides goes to the remainder list.
template <typename T>
__global__ void __launch_bounds__(kTile) later_pass(
    StepState<T> st, const T* __restrict__ tri,
    const int* __restrict__ counts, const T* __restrict__ sv_width,
    const T* __restrict__ voxel, int n0, int n1, int n2, int k_pad,
    T edge_tol, const int* __restrict__ perm,
    const int4* __restrict__ tiles, const int* __restrict__ n_tiles) {
  __shared__ TileRows<T, kLaterStage> sm;
  if ((int)blockIdx.x >= *n_tiles) return;
  const int4 tl = tiles[blockIdx.x];
  const int cell = tl.x, s_count = tl.z;
  const int L = lanes_per_spin(s_count);
  const int slot = threadIdx.x / L;
  const int lane = threadIdx.x & (L - 1);
  const bool live = slot < s_count;
  const int nsv[3] = {n0, n1, n2};
  T p[3] = {T(0), T(0), T(0)}, dd[3] = {T(0), T(0), T(0)};
  T s[3] = {T(0), T(0), T(0)}, rm = T(0);
  int i = 0;
  if (live) {
    i = perm[tl.y + slot];
    for (int a = 0; a < 3; ++a) {
      p[a] = st.r0[3 * i + a];
      dd[a] = st.dir[3 * i + a];
    }
    rm = st.rem[i];
    halo_cell_of(p, dd, rm, sv_width, voxel, nsv, s);
  }
  const T* row = tri + (size_t)cell * k_pad * 12;
  T best;
  int best_k;
  tile_nearest(sm, row, counts[cell], kLaterStage, live, L, lane, s, dd,
               edge_tol, best, best_k);
  if (!live || lane != 0) return;
  const int iters = st.iters[i] + 1;
  int cross = st.crossings[i];
  const bool hit = best <= add_rn(rm, slack_of(T(0)));
  if (hit) {
    T nrm[3];
    for (int a = 0; a < 3; ++a) nrm[a] = row[12 * best_k + 9 + a];
    const bool through =
        krng::bounce_uniform<T>((uint32_t)__ldg(st.seed),
                                (uint32_t)__ldg(st.t), (uint32_t)st.ids[i],
                                (uint32_t)(iters - 1)) < *st.perm;
    resolve_hit<T, true>(p, dd, rm, best, nrm, through, *st.eps);
    cross += through;
  }
  for (int a = 0; a < 3; ++a) {
    st.r0[3 * i + a] = p[a];
    st.dir[3 * i + a] = dd[a];
  }
  st.rem[i] = rm;
  st.iters[i] = iters;
  st.crossings[i] = cross;
  if (hit && rm > T(0) && iters < st.max_iter) {
    st.rest[atomicAdd(st.n_rest, 1)] = i;
  }
}

// K9's remainder: the later bounces of the spins on st.list (the launch
// passes the second check's list), each to the end of its step
// (stepping.step_mesh's compacted loop). A fixed grid of blocks walks the
// list, one warp per spin: the warp's 32 lanes split the spin's halo row
// (lane j tests records j, j + 32, ... in global memory, keeping its first
// minimum), reduce by (t, record) as the hit pass does, and every lane then
// resolves the same hit. The spin's row is chosen again for every bounce: a
// row holds only the segments whose bounding-box minimum corner lies in its
// cell (engine/mesh_accel.py), so a bounce that leaves the cell needs
// another row. Collision check k draws at bounce index k - 1.
template <typename T>
__global__ void __launch_bounds__(kBounce) bounce_pass(
    StepState<T> st, const T* __restrict__ tri,
    const int* __restrict__ counts, const T* __restrict__ sv_width,
    const T* __restrict__ voxel, int n0, int n1, int n2, int k_pad,
    T edge_tol) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * kBounce + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * kBounce) >> 5;
  const int nsv[3] = {n0, n1, n2};
  const T lo_tol = -edge_tol;
  const T hi_tol = T(1) + edge_tol;
  const uint32_t seed = (uint32_t)__ldg(st.seed);
  const uint32_t t_step = (uint32_t)__ldg(st.t);
  const T perm = *st.perm, eps = *st.eps;
  const int m = *st.n_list;
  for (int w = warp; w < m; w += n_warps) {
    const int i = st.list[w];
    T p[3], dd[3];
    for (int a = 0; a < 3; ++a) {
      p[a] = st.r0[3 * i + a];
      dd[a] = st.dir[3 * i + a];
    }
    T rm = st.rem[i];
    int iters = st.iters[i], cross = st.crossings[i];
    const uint32_t id = (uint32_t)st.ids[i];
    bool active = true;
    while (active) {
      T s[3];
      const int cell = halo_cell_of(p, dd, rm, sv_width, voxel, nsv, s);
      const int cnt = counts[cell];
      const T* row = tri + (size_t)cell * k_pad * 12;
      T best = inf_of(T(0));
      int best_k = -1;
      for (int k = lane; k < cnt; k += 32) {
        const T* q = row + 12 * k;
        const T c[9] = {q[0], q[1], q[2], q[3] - q[0], q[4] - q[1],
                        q[5] - q[2], q[6] - q[0], q[7] - q[1], q[8] - q[2]};
        T t;
        if (record_test(s, dd, c, lo_tol, hi_tol, &t) && t < best) {
          best = t;
          best_k = k;
        }
      }
      min_butterfly(best, best_k, 32);
      ++iters;
      const bool hit = best <= add_rn(rm, slack_of(T(0)));
      if (hit) {
        T nrm[3];
        for (int a = 0; a < 3; ++a) nrm[a] = row[12 * best_k + 9 + a];
        const bool through =
            krng::bounce_uniform<T>(seed, t_step, id,
                                    (uint32_t)(iters - 1)) < perm;
        resolve_hit<T, true>(p, dd, rm, best, nrm, through, eps);
        cross += through;
      }
      active = hit && rm > T(0) && iters < st.max_iter;
    }
    if (lane == 0) {
      for (int a = 0; a < 3; ++a) {
        st.r0[3 * i + a] = p[a];
        st.dir[3 * i + a] = dd[a];
      }
      st.rem[i] = rm;
      st.iters[i] = iters;
      st.crossings[i] = cross;
    }
  }
}

// The step's end: positions r0 + dir * rem as (3, n) rows, and exc.
template <typename T>
__global__ void __launch_bounds__(256) finish_pass(StepState<T> st, int n,
                                                   T* __restrict__ out,
                                                   uint8_t* __restrict__ exc) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const T rm = st.rem[i];
    for (int a = 0; a < 3; ++a) {
      out[(size_t)a * n + i] =
          add_rn(st.r0[3 * i + a], mul_rn(st.dir[3 * i + a], rm));
    }
    exc[i] = st.iters[i] >= st.max_iter;
  }
}

int max_tiles(int n, int n_cells) {
  return (n + kTile - 1) / kTile + (n < n_cells ? n : n_cells);
}

// Scratch (int32 words): cell and rank per spin, the permutation, per-cell
// fill and start, the tile count, then the tiles (int4, 16-byte aligned).
struct Scratch {
  int *cell_of, *rank_of, *perm, *fill, *start, *n_tiles;
  int4* tiles;
};

long long scratch_words(int n, int n_cells) {
  const long long head = 3LL * n + 2LL * n_cells + 1;
  return (head + 3) / 4 * 4 + 4LL * max_tiles(n, n_cells);
}

Scratch carve(void* base, int n, int n_cells) {
  int* w = static_cast<int*>(base);
  Scratch sc;
  sc.cell_of = w;
  sc.rank_of = w + n;
  sc.perm = w + 2LL * n;
  sc.fill = w + 3LL * n;
  sc.start = sc.fill + n_cells;
  sc.n_tiles = sc.start + n_cells;
  const long long head = 3LL * n + 2LL * n_cells + 1;
  sc.tiles = reinterpret_cast<int4*>(w + (head + 3) / 4 * 4);
  return sc;
}

int grid_for(int n, int threads) {
  const long long want = ((long long)n + threads - 1) / threads;
  return (int)(want < 65536 ? want : 65536);
}

// A classic step's worklists after the query scratch: their two counts
// (padded to 16 bytes), then the first pass's list and the second check's,
// up to n spin indices each.
long long step_scratch_words(int n, int n_cells) {
  return scratch_words(n, n_cells) + 4 + 2LL * n;
}

// The remainder's grid: as many blocks as fit on the card at once.
template <typename T>
int bounce_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bounce_pass<T>,
                                                  kBounce, 0);
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  return blocks;
}

// The nearest-hit query (kResolve false: min_d and normal into out_d and
// out_n), or a classic step's first pass (kResolve true: into st), as a
// memset and the four kernels on the caller's stream.
template <typename T, bool kResolve>
int launch(const void* r0, const void* dir, const void* rem, const void* tri,
           const void* counts, const void* sv_width, const void* voxel, int n,
           int n0, int n1, int n2, int k_pad, int chunk, T edge_tol,
           void* out_d, void* out_n, const StepState<T>& step, void* scratch,
           cudaStream_t st) {
  const int n_cells = n0 * n1 * n2;
  const Scratch sc = carve(scratch, n, n_cells);
  cudaError_t rc = cudaMemsetAsync(sc.fill, 0, sizeof(int) * n_cells, st);
  if (rc != cudaSuccess) return (int)rc;
  cell_pass<T><<<grid_for(n, 256), 256, 0, st>>>(
      (const T*)r0, (const T*)dir, (const T*)rem, (const T*)sv_width,
      (const T*)voxel, n, n0, n1, n2, sc.fill, sc.cell_of, sc.rank_of);
  scan_pass<<<1, kScan, 0, st>>>(sc.fill, n_cells, sc.start, sc.tiles,
                                 sc.n_tiles);
  scatter_pass<<<grid_for(n, 256), 256, 0, st>>>(sc.cell_of, sc.rank_of,
                                                 sc.start, n, sc.perm);
  const int stage = chunk < kStage ? chunk : kStage;
  hit_pass<T, kResolve><<<max_tiles(n, n_cells), kTile, 0, st>>>(
      (const T*)r0, (const T*)dir, (const T*)rem, (const T*)tri,
      (const int*)counts, (const T*)sv_width, (const T*)voxel, n0, n1, n2,
      k_pad, stage, edge_tol, sc.perm, sc.tiles, sc.n_tiles, (T*)out_d,
      (T*)out_n, step);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_query(const void* r0, const void* dir, const void* rem,
                 const void* tri, const void* counts, const void* sv_width,
                 const void* voxel, int n, int n0, int n1, int n2, int k_pad,
                 int chunk, T edge_tol, void* out_d, void* out_n,
                 void* scratch, void* stream) {
  return launch<T, false>(r0, dir, rem, tri, counts, sv_width, voxel, n, n0,
                          n1, n2, k_pad, chunk, edge_tol, out_d, out_n,
                          StepState<T>{}, scratch, (cudaStream_t)stream);
}

// One classic mesh step: the first pass with its resolve; K9: the listed
// spins sorted by cell, their second check on staged rows, the remainder's
// warp-per-spin loop; the tail. The first pass's query scratch serves the
// sort again once the hit pass is done (stream order).
template <typename T>
int launch_step(const void* r0, const void* dir, const void* rem,
                const void* tri, const void* counts, const void* sv_width,
                const void* voxel, int n, int n0, int n1, int n2, int k_pad,
                int chunk, T edge_tol, const void* ids, const void* seed,
                const void* t, const void* perm, const void* eps,
                int max_iter, void* s_r0, void* s_dir, void* s_rem,
                void* iters, void* crossings, void* out, void* exc,
                void* scratch, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int n_cells = n0 * n1 * n2;
  int* head = static_cast<int*>(scratch) + scratch_words(n, n_cells);
  StepState<T> step{(T*)s_r0,        (T*)s_dir,       (T*)s_rem,
                    (int*)iters,     (int*)crossings, head + 4,
                    head,            head + 4 + n,    head + 1,
                    (const int*)ids, (const int*)seed, (const int*)t,
                    (const T*)perm,  (const T*)eps,   max_iter};
  cudaError_t rc = cudaMemsetAsync(head, 0, 2 * sizeof(int), st);
  if (rc != cudaSuccess) return (int)rc;
  int err = launch<T, true>(r0, dir, rem, tri, counts, sv_width, voxel, n,
                            n0, n1, n2, k_pad, chunk, edge_tol, nullptr,
                            nullptr, step, scratch, st);
  if (err != 0) return err;
  const Scratch sc = carve(scratch, n, n_cells);
  rc = cudaMemsetAsync(sc.fill, 0, sizeof(int) * n_cells, st);
  if (rc != cudaSuccess) return (int)rc;
  relist_cells<T><<<grid_for(n, 256), 256, 0, st>>>(
      step, (const T*)sv_width, (const T*)voxel, n0, n1, n2, sc.fill,
      sc.cell_of, sc.rank_of);
  relist_scan<<<1, kScan, 0, st>>>(sc.fill, n_cells, sc.start, sc.tiles,
                                   sc.n_tiles);
  relist_scatter<<<grid_for(n, 256), 256, 0, st>>>(
      step.list, step.n_list, sc.cell_of, sc.rank_of, sc.start, sc.perm);
  later_pass<T><<<max_tiles(n, n_cells), kTile, 0, st>>>(
      step, (const T*)tri, (const int*)counts, (const T*)sv_width,
      (const T*)voxel, n0, n1, n2, k_pad, edge_tol, sc.perm, sc.tiles,
      sc.n_tiles);
  StepState<T> rest = step;
  rest.list = step.rest;
  rest.n_list = step.n_rest;
  bounce_pass<T><<<bounce_blocks<T>(), kBounce, 0, st>>>(
      rest, (const T*)tri, (const int*)counts, (const T*)sv_width,
      (const T*)voxel, n0, n1, n2, k_pad, edge_tol);
  finish_pass<T><<<grid_for(n, 256), 256, 0, st>>>(step, n, (T*)out,
                                                   (uint8_t*)exc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

long long mesh_hit_scratch_words(int n, int n_cells) {
  return scratch_words(n, n_cells);
}

long long mesh_step_scratch_words(int n, int n_cells) {
  return step_scratch_words(n, n_cells);
}

int mesh_hit_launch_f32(const void* r0, const void* dir, const void* rem,
                        const void* tri, const void* counts,
                        const void* sv_width, const void* voxel, int n, int n0,
                        int n1, int n2, int k_pad, int chunk, float edge_tol,
                        void* out_d, void* out_n, void* scratch,
                        void* stream) {
  return launch_query<float>(r0, dir, rem, tri, counts, sv_width, voxel, n,
                             n0, n1, n2, k_pad, chunk, edge_tol, out_d, out_n,
                             scratch, stream);
}

int mesh_hit_launch_f64(const void* r0, const void* dir, const void* rem,
                        const void* tri, const void* counts,
                        const void* sv_width, const void* voxel, int n, int n0,
                        int n1, int n2, int k_pad, int chunk, double edge_tol,
                        void* out_d, void* out_n, void* scratch,
                        void* stream) {
  return launch_query<double>(r0, dir, rem, tri, counts, sv_width, voxel, n,
                              n0, n1, n2, k_pad, chunk, edge_tol, out_d,
                              out_n, scratch, stream);
}

// r0, dir (n, 3) and rem (n,) start the step; ids, seed, t, perm, eps and
// max_iter as StepState; s_r0, s_dir, s_rem, iters and crossings receive
// the state K9 carries, out the (3, n) end positions and exc the flags.
int mesh_step_launch_f32(const void* r0, const void* dir, const void* rem,
                         const void* tri, const void* counts,
                         const void* sv_width, const void* voxel, int n,
                         int n0, int n1, int n2, int k_pad, int chunk,
                         float edge_tol, const void* ids, const void* seed,
                         const void* t, const void* perm, const void* eps,
                         int max_iter, void* s_r0, void* s_dir, void* s_rem,
                         void* iters, void* crossings, void* out, void* exc,
                         void* scratch, void* stream) {
  return launch_step<float>(r0, dir, rem, tri, counts, sv_width, voxel, n, n0,
                            n1, n2, k_pad, chunk, edge_tol, ids, seed, t,
                            perm, eps, max_iter, s_r0, s_dir, s_rem, iters,
                            crossings, out, exc, scratch, stream);
}

int mesh_step_launch_f64(const void* r0, const void* dir, const void* rem,
                         const void* tri, const void* counts,
                         const void* sv_width, const void* voxel, int n,
                         int n0, int n1, int n2, int k_pad, int chunk,
                         double edge_tol, const void* ids, const void* seed,
                         const void* t, const void* perm, const void* eps,
                         int max_iter, void* s_r0, void* s_dir, void* s_rem,
                         void* iters, void* crossings, void* out, void* exc,
                         void* scratch, void* stream) {
  return launch_step<double>(r0, dir, rem, tri, counts, sv_width, voxel, n,
                             n0, n1, n2, k_pad, chunk, edge_tol, ids, seed, t,
                             perm, eps, max_iter, s_r0, s_dir, s_rem, iters,
                             crossings, out, exc, scratch, stream);
}

}  // extern "C"
