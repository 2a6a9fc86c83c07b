"""The classic engine's per-cell mesh layout, on the CPU.

``mesh_accel.pack_mesh`` falls back to the per-cell layout when the halo
table would exceed ``HALO_BYTES_LIMIT``; the tests set the limit to 0 in
both packages, so small meshes pack it. On the card its query is K10 and
its step K10 with the first bounce resolved plus K9's remainder over the
stencil (``csrc/mesh_hit.cu``); here the plain versions run.

- K10's traversal, written out in plain torch (L lanes per spin; lane j
  tests records j, j + L, ... of every stencil cell the segment's box
  overlaps, up to the cell's count, keeping its first minimum by a strict
  <; the lanes reduce by (t, offset, record)), equals the gather query
  ``mesh_accel.nearest_hit`` bit for bit: distances, normals and the slot
  that wins, at every L, on spans (2, 2, 2) and (3, 3, 3) packs and on a
  hand-built tie across two cells.
- So does K10's first pass as the kernel schedules it: the spins sorted
  by the wrapped cell of their box's minimum corner (the key pass with
  spins arriving in any order, the two-pass scan of the cells' counts in
  blocks of 1,024 cells, the scatter), each spin then walking only the
  offsets inside its box with its wrap stepped from the base cell's. The
  sort's order is a permutation of the spins, grouped by cell in the
  cells' order.
- The plain per-cell step gives every spin the same result under a
  permutation of the spins: the kernels' cell order and list order do not
  change a spin's walk.
- One plain per-cell step, fed the JAX engine's draws, against the JAX
  package's ``step_mesh`` on the same pack: positions within float32
  rounding (1e-5 step lengths), exc and crossings equal.
- A whole per-cell ``simulation()`` (float64) against the JAX package's
  run stored by ``scripts/make_torch_oracles.py`` (``percell_*``): the two
  draw from different generators, so the signals agree within 4.5
  standard errors of their difference, and every spin stays in the
  cylinder.
- On CUDA tensors a per-cell step goes to the mesh step kernels, with no
  plain query: shown with a stand-in for the kernel.
"""

import pickle

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax
import jax.numpy as jnp

from disimpy_tpu import meshes as jmeshes
from disimpy_tpu import substrates as jsub
from disimpy_tpu.engine import mesh_accel as jaccel
from disimpy_tpu.engine import rng as jrng
from disimpy_tpu.engine import stepping as jstep
from disimpy_tpu_torch import gradients, meshes, simulations, substrates
from disimpy_tpu_torch.engine import (config, geometry, launch_count,
                                      mesh_accel, mesh_kernel, specs,
                                      stepping)

import torch_threads  # noqa: F401  (shares the cores among xdist workers)

D = 2e-9
STEP_L = float(np.sqrt(6 * D * 8e-5))
MESH_FIELDS = ("tri", "cell_counts", "voxel_size", "sv_width", "perm_prob")
# The stored whole run (scripts/make_torch_oracles.py, percell_*).
RUN_SPINS, RUN_STEPS, RUN_SEED = 1024, 40, 7
RUN_BVALS = np.array([0.0, 1e9, 2e9, 4e9])


@pytest.fixture
def per_cell(monkeypatch):
    monkeypatch.setattr(jaccel, "HALO_BYTES_LIMIT", 0)
    monkeypatch.setattr(mesh_accel, "HALO_BYTES_LIMIT", 0)


def _icosphere(n_sv):
    vertices, faces = meshes.icosphere(radius=5e-6, subdivisions=2)
    return substrates.mesh(vertices, faces, True, n_sv=np.array([n_sv] * 3),
                           quiet=True)


def _query_inputs(spec, n=600, seed=1):
    """Spins partly outside the voxel (the wrap and shift are exercised),
    random unit directions, rem in (0, 1]."""
    rng = np.random.RandomState(seed)
    voxel = spec.voxel_size.numpy()
    r0 = (rng.random_sample((n, 3)) * 1.4 - 0.2) * voxel
    direction = rng.standard_normal((n, 3))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    rem = 1.0 - rng.random_sample(n)
    dtype = spec.tri.dtype
    return tuple(torch.tensor(x, dtype=dtype) for x in (r0, direction, rem))


def k10_traversal(spec, r0, direction, rem, edge_tol, lanes):
    """K10's query in plain torch, in the kernel's order: returns (min_d,
    normal, winning (offset, record) key, -1 where nothing is hit)."""
    n = r0.shape[0]
    n_cells = spec.tri.shape[0]
    k_pad = spec.tri.shape[1] * spec.tri.shape[2]
    rows = spec.tri.reshape(n_cells, k_pad, 12)
    n_sv = torch.tensor(spec.n_sv, dtype=torch.int32)
    seg_end = r0 + direction * rem[:, None]
    lo = torch.minimum(r0, seg_end)
    hi = torch.maximum(r0, seg_end)
    base = torch.floor(lo / spec.sv_width).to(torch.int32)
    upper = torch.maximum(torch.ceil(hi / spec.sv_width).to(torch.int32),
                          base + 1)
    inf = float("inf")
    best = torch.full((n, lanes), inf, dtype=r0.dtype)
    key = torch.full((n, lanes), -1, dtype=torch.int64)
    rec = torch.full((n, lanes), -1, dtype=torch.int64)
    spins = torch.arange(n)
    for o, off in enumerate(mesh_accel._slot_offsets(spec.spans)):
        idx = base + torch.as_tensor(off)
        inside = torch.all(idx < upper, dim=1)
        shift = torch.div(idx, n_sv, rounding_mode="floor")
        wrapped = idx - shift * n_sv
        sv = ((wrapped[:, 0] * n_sv[1] + wrapped[:, 1]) * n_sv[2]
              + wrapped[:, 2]).long()
        shifted = r0 - shift.to(r0.dtype) * spec.voxel_size
        t = geometry.ray_triangle_intersection(
            rows[sv, :, :9].reshape(n, k_pad, 3, 3), shifted[:, None, :],
            direction[:, None, :], edge_tol=edge_tol)
        k = torch.arange(k_pad)
        t = torch.where(inside[:, None] & (k < spec.cell_counts[sv][:, None])
                        & (t > 0), t, torch.full_like(t, inf))
        # Lane j's records j, j + L, ...: its first minimum in this cell,
        # then a strict < against what it kept from the earlier cells.
        steps = -(-k_pad // lanes)
        t = torch.cat((t, torch.full((n, steps * lanes - k_pad), inf,
                                     dtype=t.dtype)), dim=1)
        t = t.reshape(n, steps, lanes)
        first = t.argmin(dim=1)  # (n, lanes)
        t_lane = t.gather(1, first[:, None, :])[:, 0, :]
        k_lane = first * lanes + torch.arange(lanes)
        better = t_lane < best
        best = torch.where(better, t_lane, best)
        key = torch.where(better, o * k_pad + k_lane, key)
        rec = torch.where(better, sv[:, None] * k_pad + k_lane, rec)
    # The butterfly: the lexicographic minimum of (t, key) over the lanes.
    min_d = best.min(dim=1).values
    tied = torch.where(best == min_d[:, None], key,
                       torch.full_like(key, 1 << 62))
    win = tied.argmin(dim=1)
    win_key = key[spins, win]
    win_rec = rec[spins, win]
    normal = torch.where((win_rec >= 0)[:, None],
                         rows.reshape(-1, 12)[win_rec.clamp(min=0), 9:12],
                         torch.zeros((n, 3), dtype=r0.dtype))
    return min_d, normal, win_key


# csrc/mesh_hit.cu: cells per block of the sort's scan (kScanCells).
K_SCAN_CELLS = 1024


def _flat(spec, w):
    n_sv = spec.n_sv
    return ((w[:, 0] * n_sv[1] + w[:, 1]) * n_sv[2] + w[:, 2]).long()


def _box(spec, r0, direction, rem):
    """Stencil::box: each spin's offsets per axis inside its box (ext =
    min(upper - base, spans)) and its base cell as whole voxels (sh0) plus
    the wrapped cell (w0)."""
    n_sv = torch.tensor(spec.n_sv, dtype=torch.int32)
    seg_end = r0 + direction * rem[:, None]
    base = torch.floor(torch.minimum(r0, seg_end) / spec.sv_width).to(
        torch.int32)
    upper = torch.maximum(torch.ceil(torch.maximum(r0, seg_end)
                                     / spec.sv_width).to(torch.int32),
                          base + 1)
    ext = torch.minimum(upper - base, torch.tensor(spec.spans))
    sh0 = torch.div(base, n_sv, rounding_mode="floor")
    return ext, sh0, base - sh0 * n_sv


def k10_sort(spec, r0, direction, rem, seed=0):
    """K10's sort: stencil_cells (each spin's wrapped base cell and its
    rank there, the spins arriving in a random order, as atomics give
    them), stencil_sums and stencil_scan (each block of K_SCAN_CELLS
    cells offset by the totals of the blocks before it, then the cells'
    exclusive scan within the block), stencil_scatter. Returns the
    permutation and each spin's cell."""
    n = r0.shape[0]
    _, _, w0 = _box(spec, r0, direction, rem)
    cell = _flat(spec, w0)
    n_cells = int(np.prod(spec.n_sv))
    arrival = torch.randperm(n, generator=torch.Generator().manual_seed(seed))
    fill = torch.zeros(n_cells, dtype=torch.int64)
    rank = torch.empty(n, dtype=torch.int64)
    for i in arrival.tolist():
        rank[i] = fill[cell[i]]
        fill[cell[i]] += 1
    blocks = fill.split(K_SCAN_CELLS)
    sums = torch.stack([b.sum() for b in blocks])
    start = torch.cat([(torch.cumsum(b, 0) - b) + (sums[:j].sum())
                       for j, b in enumerate(blocks)])
    perm = torch.full((n,), -1, dtype=torch.int64)
    perm[start[cell] + rank] = torch.arange(n)
    return perm, cell


def k10_sorted(spec, r0, direction, rem, edge_tol, lanes, perm):
    """K10's first pass in plain torch, as stencil_pass runs it on the
    sort's order ``perm``: L lanes per spin; each spin walks the offsets
    inside its box (in _slot_offsets order) with each wrap stepped from the
    base cell's; lane j tests records j, j + L, ... of every visited row;
    lane 0 writes at the spin's own index. Returns (min_d, normal, winning
    (offset, record) key), in the caller's order."""
    n = r0.shape[0]
    k_pad = spec.tri.shape[1] * spec.tri.shape[2]
    rows = spec.tri.reshape(-1, k_pad, 12)
    n_sv = torch.tensor(spec.n_sv, dtype=torch.int32)
    r0, direction, rem = r0[perm], direction[perm], rem[perm]
    ext, sh0, w0 = _box(spec, r0, direction, rem)
    inf = float("inf")
    best = torch.full((n, lanes), inf, dtype=r0.dtype)
    key = torch.full((n, lanes), -1, dtype=torch.int64)
    rec = torch.full((n, lanes), -1, dtype=torch.int64)
    k = torch.arange(k_pad)
    for o, off in enumerate(mesh_accel._slot_offsets(spec.spans)):
        off = torch.as_tensor(off)
        inside = torch.all(off < ext, dim=1)
        w, sh = w0 + off, sh0.clone()
        while bool((w >= n_sv).any()):  # Stencil::step_to
            over = w >= n_sv
            w, sh = torch.where(over, w - n_sv, w), sh + over.to(sh.dtype)
        sv = _flat(spec, w)
        t = geometry.ray_triangle_intersection(
            rows[sv, :, :9].reshape(n, k_pad, 3, 3),
            (r0 - sh.to(r0.dtype) * spec.voxel_size)[:, None, :],
            direction[:, None, :], edge_tol=edge_tol)
        t = torch.where(inside[:, None] & (k < spec.cell_counts[sv][:, None])
                        & (t > 0), t, torch.full_like(t, inf))
        # Lane j's first minimum in this row, then a strict < against what
        # it kept from the earlier rows.
        steps = -(-k_pad // lanes)
        t = torch.cat((t, torch.full((n, steps * lanes - k_pad), inf,
                                     dtype=t.dtype)), dim=1)
        t = t.reshape(n, steps, lanes)
        first = t.argmin(dim=1)
        t_lane = t.gather(1, first[:, None, :])[:, 0, :]
        k_lane = first * lanes + torch.arange(lanes)
        better = t_lane < best
        best = torch.where(better, t_lane, best)
        key = torch.where(better, o * k_pad + k_lane, key)
        rec = torch.where(better, sv[:, None] * k_pad + k_lane, rec)
    min_d = best.min(dim=1).values
    tied = torch.where(best == min_d[:, None], key,
                       torch.full_like(key, 1 << 62))
    win = tied.argmin(dim=1)
    spins = torch.arange(n)
    win_rec = rec[spins, win]
    normal = torch.where((win_rec >= 0)[:, None],
                         rows.reshape(-1, 12)[win_rec.clamp(min=0), 9:12],
                         torch.zeros((n, 3), dtype=r0.dtype))
    out_d, out_n = torch.empty_like(min_d), torch.empty_like(normal)
    out_key = torch.empty_like(win_rec)
    out_d[perm], out_n[perm], out_key[perm] = min_d, normal, key[spins, win]
    return out_d, out_n, out_key


def _crowded_inputs(spec, n=300, seed=2):
    """Spins crowded into the cell with the most triangles and the next
    one along x, half of them moved by whole voxels (one base cell, other
    shifts), plus a spread: from one spin to hundreds per base cell."""
    rng = np.random.RandomState(seed)
    voxel = spec.voxel_size.numpy().astype(float)
    width = spec.sv_width.numpy().astype(float)
    corner = np.array(np.unravel_index(int(spec.cell_counts.argmax()),
                                       spec.n_sv), dtype=float)
    r0 = np.concatenate([
        (corner + rng.random_sample((n, 3)) * 0.9 + 0.05) * width,
        (corner + rng.random_sample((n, 3)) * 0.9 + [1.05, 0.05, 0.05])
        * width])
    r0[::2] += voxel * rng.randint(-1, 2, (len(r0[::2]), 3))
    r0 = np.concatenate([r0, (rng.random_sample((n, 3)) * 1.4 - 0.2)
                         * voxel])
    direction = rng.standard_normal((len(r0), 3))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    rem = 1.0 - rng.random_sample(len(r0))
    dtype = spec.tri.dtype
    return tuple(torch.tensor(x, dtype=dtype) for x in (r0, direction, rem))


# n_sv 1: every spin in one base cell, and every offset past the first
# along an axis wraps onto that cell a whole voxel over.
@pytest.mark.parametrize("n_sv, spans",
                         [(1, (2, 2, 2)), (4, (2, 2, 2)), (16, (3, 3, 3))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k10_sorted_pass_equals_gather_query(per_cell, n_sv, spans, dtype):
    spec = mesh_accel.pack_mesh(_icosphere(n_sv), 1 / STEP_L, dtype)
    assert spec.spans == spans
    edge_tol = mesh_kernel.EDGE_TOL[dtype]
    for inputs in (_query_inputs(spec), _crowded_inputs(spec)):
        r0, direction, rem = inputs
        d_ref, n_ref = mesh_accel.nearest_hit(spec, r0, direction, rem,
                                              edge_tol=edge_tol)
        key_ref = _gather_key(spec, r0, direction, rem, edge_tol)
        hits = torch.isfinite(d_ref)
        assert int((d_ref <= rem).sum()) > 20
        outside = ((r0 < 0) | (r0 >= spec.voxel_size)).any(dim=1)
        assert int(outside.sum()) > 20  # the shifts are exercised
        perm, cell = k10_sort(spec, r0, direction, rem)
        assert torch.equal(torch.sort(perm).values, torch.arange(len(perm)))
        assert bool((cell[perm].diff() >= 0).all())
        for lanes in (1, 4, 32):
            d, normal, key = k10_sorted(spec, r0, direction, rem, edge_tol,
                                        lanes, perm)
            assert torch.equal(d, d_ref), lanes
            assert torch.equal(normal, n_ref), lanes
            assert torch.equal(key[hits], key_ref[hits]), lanes
            assert bool((key[~hits] < 0).all())


def _gather_key(spec, r0, direction, rem, edge_tol):
    """The (offset, record) key of the gather query's answer: the first
    stencil offset whose own nearest hit is the query's distance, and the
    lowest slot there."""
    k_pad = spec.tri.shape[1] * spec.tri.shape[2]
    d_all, _ = mesh_accel.nearest_hit(spec, r0, direction, rem,
                                      edge_tol=edge_tol)
    key = torch.full((r0.shape[0],), -1, dtype=torch.int64)
    for o, off in enumerate(mesh_accel._slot_offsets(spec.spans)):
        d_o, slot = _offset_hits(spec, off, r0, direction, rem, edge_tol)
        first = (key < 0) & (d_o == d_all) & torch.isfinite(d_all)
        key = torch.where(first, o * k_pad + slot, key)
    return key


def _offset_hits(spec, off, r0, direction, rem, edge_tol):
    """The nearest hit and its slot within the one stencil offset ``off``
    (inf and -1 where the offset is outside the box or nothing is hit)."""
    n = r0.shape[0]
    k_pad = spec.tri.shape[1] * spec.tri.shape[2]
    rows = spec.tri.reshape(-1, k_pad, 12)
    n_sv = torch.tensor(spec.n_sv, dtype=torch.int32)
    seg_end = r0 + direction * rem[:, None]
    base = torch.floor(torch.minimum(r0, seg_end) / spec.sv_width).to(
        torch.int32)
    upper = torch.maximum(torch.ceil(torch.maximum(r0, seg_end)
                                     / spec.sv_width).to(torch.int32),
                          base + 1)
    idx = base + torch.as_tensor(off)
    inside = torch.all(idx < upper, dim=1)
    shift = torch.div(idx, n_sv, rounding_mode="floor")
    wrapped = idx - shift * n_sv
    sv = ((wrapped[:, 0] * n_sv[1] + wrapped[:, 1]) * n_sv[2]
          + wrapped[:, 2]).long()
    t = geometry.ray_triangle_intersection(
        rows[sv, :, :9].reshape(n, k_pad, 3, 3),
        (r0 - shift.to(r0.dtype) * spec.voxel_size)[:, None, :],
        direction[:, None, :], edge_tol=edge_tol)
    t = torch.where(inside[:, None] & (t > 0), t,
                    torch.full_like(t, float("inf")))
    slot = t.argmin(dim=1)  # the first minimum
    d = t[torch.arange(n), slot]
    return d, torch.where(torch.isfinite(d), slot, torch.full_like(slot, -1))


@pytest.mark.parametrize("n_sv, spans", [(4, (2, 2, 2)), (16, (3, 3, 3))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k10_traversal_equals_gather_query(per_cell, n_sv, spans, dtype):
    spec = mesh_accel.pack_mesh(_icosphere(n_sv), 1 / STEP_L, dtype)
    assert spec.spans == spans
    r0, direction, rem = _query_inputs(spec)
    edge_tol = mesh_kernel.EDGE_TOL[dtype]
    d_ref, n_ref = mesh_accel.nearest_hit(spec, r0, direction, rem,
                                          edge_tol=edge_tol)
    key_ref = _gather_key(spec, r0, direction, rem, edge_tol)
    hits = torch.isfinite(d_ref)
    assert int((d_ref <= rem).sum()) > 20  # the case collides
    assert int(torch.isinf(d_ref).sum()) > 20  # and misses
    for lanes in (1, 4, 8, 32):
        d, normal, key = k10_traversal(spec, r0, direction, rem, edge_tol,
                                       lanes)
        assert torch.equal(d, d_ref), lanes
        assert torch.equal(normal, n_ref), lanes
        assert torch.equal(key[hits], key_ref[hits]), lanes
        assert bool((key[~hits] < 0).all())
    # nearest_hit on a CPU tensor is the gather query itself.
    for a, b in zip(mesh_kernel.nearest_hit(spec, r0, direction, rem),
                    (d_ref, n_ref)):
        assert torch.equal(a, b)


def _plane(x):
    """A triangle in the plane at ``x`` covering 0 <= y, z, y + z <= 2."""
    return np.array([x, 0, 0, x, 2.0, 0, x, 0, 2.0])


def _two_cell_tie_spec(first_slot):
    """Two unit cells along x (voxel 2 x 1 x 1, spans (2, 2, 2)), each
    wall stored in both cells beside it with different normals: x = 1 in
    cell 0 (normal x, at slot ``first_slot``, behind an all-zero padding
    record when 1) and in cell 1 (normal y, slot 0); x = 0 in cell 0
    (normal z, after x = 1) and, as its periodic image x = 2, in cell 1
    (normal -z, slot 1)."""
    k_pad = first_slot + 2
    rows = np.zeros((2, k_pad, 12), np.float32)
    rows[0, first_slot] = np.r_[_plane(1.0), 1.0, 0, 0]
    rows[0, first_slot + 1] = np.r_[_plane(0.0), 0, 0, 1.0]
    rows[1, 0] = np.r_[_plane(1.0), 0, 1.0, 0]
    rows[1, 1] = np.r_[_plane(2.0), 0, 0, -1.0]
    return specs.MeshSpec(
        tri=torch.tensor(rows.reshape(2, 1, k_pad, 12)),
        cell_counts=torch.tensor([k_pad, 2], dtype=torch.int32),
        voxel_size=torch.tensor([2.0, 1.0, 1.0]),
        sv_width=torch.tensor([1.0, 1.0, 1.0]),
        perm_prob=torch.tensor(0.0), n_sv=(2, 1, 1), spans=(2, 2, 2),
        chunk=k_pad)


@pytest.mark.parametrize("first_slot", [0, 1])
def test_tie_across_two_cells_takes_the_first_cell(first_slot):
    spec = _two_cell_tie_spec(first_slot)
    # Along +x at y = z = 0.5: from x = 0.5 the box covers cells 0 then 1,
    # which both hold x = 1 (t = 0.5); from x = 1.5 it covers cell 1 then
    # cell 0's periodic image, which hold x = 2 and its image x = 0.
    r0 = torch.tensor([[0.5, 0.5, 0.5], [1.5, 0.5, 0.5]])
    direction = torch.tensor([[1.0, 0, 0], [1.0, 0, 0]])
    rem = torch.ones(2)
    d_ref, n_ref = mesh_accel.nearest_hit(spec, r0, direction, rem,
                                          edge_tol=1e-5)
    npt.assert_array_equal(d_ref.numpy(), [0.5, 0.5])
    npt.assert_array_equal(n_ref.numpy(), [[1.0, 0, 0], [0, 0, -1.0]])
    for lanes in (1, 2, 32):
        d, normal, key = k10_traversal(spec, r0, direction, rem, 1e-5, lanes)
        assert torch.equal(d, d_ref) and torch.equal(normal, n_ref)
        # The first cell's slot, at stencil offset (0, 0, 0) both times.
        npt.assert_array_equal(key.numpy(), [first_slot, 1])


def _jax_draws(key, n):
    """The JAX mesh step's directions (3, n) and its first pass's
    uniforms, as the port's ``directions`` and ``uniform(bounce, idx)``;
    the later passes draw per compacted slot in JAX, per spin here."""
    from disimpy_tpu_torch.engine import krng

    directions = np.array(jrng.random_unit_steps(jrng.bounce_key(key, 0), n,
                                                 jnp.float32))
    first = torch.from_numpy(np.asarray(
        jrng.uniforms(jrng.bounce_key(key, 1), n, jnp.float32)))

    def uniform(bounce, idx=None):
        if not isinstance(bounce, int):
            return krng.bounce_uniform(7, 0, idx.to(torch.int32), bounce)
        assert bounce == 0
        return first if idx is None else first[idx]

    return torch.from_numpy(directions), uniform


def test_per_cell_step_matches_jax(per_cell):
    vertices, faces = jmeshes.icosphere(radius=5e-6, subdivisions=2)
    sub_j = jsub.mesh(vertices, faces, True, n_sv=np.array([4, 4, 4]),
                      quiet=True)
    spec_j = jaccel.pack_mesh(sub_j, 1 / STEP_L, jnp.float32)
    assert tuple(spec_j.spans) == (2, 2, 2)
    spec_t = specs.spec_from_numpy(
        {k: np.asarray(getattr(spec_j, k)) for k in MESH_FIELDS},
        dict(kind="mesh", n_sv=spec_j.n_sv, spans=spec_j.spans,
             chunk=spec_j.chunk), "cpu")
    n = 512
    vox = np.asarray(sub_j.voxel_size) / STEP_L
    pos = (np.random.RandomState(3).random_sample((n, 3)) * vox).T.astype(
        np.float32)
    eps = 64 * float(np.finfo(np.float32).eps) * 3.0 * np.sqrt(10)
    key = jax.random.PRNGKey(4)
    p_j, exc_j, cr_j = jax.jit(jstep.step_mesh)(
        jnp.asarray(pos), key, spec_j, jnp.asarray(eps, jnp.float32),
        jnp.asarray(1000, jnp.int32))
    directions, uniform = _jax_draws(key, n)
    p_t, exc_t, cr_t = stepping.step_mesh(torch.from_numpy(pos), spec_t, eps,
                                          1000, directions, uniform)
    npt.assert_array_equal(exc_t.numpy(), np.asarray(exc_j))
    npt.assert_array_equal(cr_t.numpy(), np.asarray(cr_j))
    npt.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0, atol=1e-5)
    # The case bounces: some spins end off their straight-line step.
    off = np.linalg.norm(p_t.numpy() - (pos + directions.numpy()), axis=0)
    assert (off > 1e-4).sum() > 20


def test_per_cell_simulation_matches_stored_jax_run(per_cell, oracles_dir):
    with open(oracles_dir / "cylinder_mesh_closed.pkl", "rb") as f:
        mesh = pickle.load(f)
    sub = substrates.mesh(mesh["vertices"], mesh["faces"], True,
                          init_pos="intra", n_sv=np.array([10, 10, 10]),
                          quiet=True)
    gradient, dt = gradients.pgse(1e-3, 2e-3, RUN_STEPS, RUN_BVALS,
                                  np.tile([1.0, 0.0, 0.0], (len(RUN_BVALS), 1)))
    signals, pos = simulations.simulation(
        RUN_SPINS, D, gradient, dt, sub, seed=RUN_SEED, dtype="float64",
        all_signals=True, final_pos=True, quiet=True, device="cpu")
    assert any(k[0] == "classic-torch" and tuple(v.spans) != (1, 1, 1)
               for k, v in sub._accel_cache.items())
    with np.load(oracles_dir / "jax_reference_runs.npz") as data:
        jax_signals = data["percell_signals"]
        jax_pos = data["percell_pos"]
    assert signals.shape == jax_signals.shape == (len(RUN_BVALS), RUN_SPINS)
    mean_t, mean_j = signals.mean(axis=1), jax_signals.mean(axis=1)
    stderr = np.sqrt((signals.var(axis=1) + jax_signals.var(axis=1))
                     / RUN_SPINS)
    npt.assert_allclose(mean_t[0], 1.0)
    assert np.all(np.abs(mean_t - mean_j) <= 4.5 * stderr + 1e-12), (
        mean_t, mean_j, stderr)
    assert mean_t[-1] < 0.5  # the gradient dephases
    # Both stay in the cylinder (axis z through the voxel's centre).
    centre = np.max(sub.vertices, axis=0)[0:2] / 2
    r = np.max(np.linalg.norm(sub.vertices[:, 0:2] - centre, axis=1))
    for p in (pos, jax_pos):
        assert np.linalg.norm(p[:, 0:2] - centre, axis=1).max() < r


@pytest.mark.parametrize("perm", [0.0, 0.5])
def test_plain_per_cell_step_is_invariant_under_a_permutation(per_cell, perm):
    spec = mesh_accel.pack_mesh(_icosphere(4), 1 / STEP_L, torch.float32)
    assert tuple(spec.spans) == (2, 2, 2)
    spec = specs.MeshSpec(**{**spec.__dict__,
                             "perm_prob": torch.tensor(perm)})
    # Spins within a step of the sphere's wall, inside and out, some of
    # them moved by whole voxels.
    rs = np.random.RandomState(5)
    n = 1024
    shell = rs.standard_normal((n, 3))
    shell /= np.linalg.norm(shell, axis=1, keepdims=True)
    voxel = spec.voxel_size.numpy().astype(float)
    centre = voxel / 2
    pos = (centre + (5e-6 / STEP_L) * rs.uniform(0.85, 1.15, (n, 1)) * shell
           + voxel * rs.randint(-1, 2, (n, 3)) * (rs.random_sample((n, 1))
                                                  < 0.2))
    pos = torch.tensor(pos.T, dtype=torch.float32).contiguous()
    ids = torch.arange(100, 100 + n, dtype=torch.int32)
    eps = 64 * float(np.finfo(np.float32).eps) * 8.0
    out = stepping.plain_step("mesh", pos, spec, eps, 1000, 31, 5, ids)
    p = torch.randperm(n, generator=torch.Generator().manual_seed(6))
    got = stepping.plain_step("mesh", pos[:, p].contiguous(), spec, eps,
                              1000, 31, 5, ids[p].contiguous())
    assert torch.equal(got[0], out[0][:, p])
    assert torch.equal(got[1], out[1][p])
    assert torch.equal(got[2], out[2][p])
    # The case reaches the second check and the remainder.
    again = stepping.plain_step("mesh", pos, spec, eps, 3, 31, 5, ids)[1]
    listed = stepping.plain_step("mesh", pos, spec, eps, 2, 31, 5, ids)[1]
    assert int(listed.sum()) > 100 and int(again.sum()) > 5


class _FakeCuda(torch.Tensor):
    """A CPU tensor that says it is on CUDA, for the dispatch alone."""

    @property
    def is_cuda(self):
        return True


def test_cuda_per_cell_step_dispatches_to_the_kernels(per_cell, monkeypatch):
    spec = mesh_accel.pack_mesh(_icosphere(4), 1 / STEP_L, torch.float32)
    assert tuple(spec.spans) != (1, 1, 1)
    n = 64
    pos = (torch.rand((3, n), generator=torch.Generator().manual_seed(0))
           * spec.voxel_size[:, None])
    ids = torch.arange(n, dtype=torch.int32)
    monkeypatch.setattr(launch_count, "counts",
                        dict.fromkeys(launch_count.KERNELS, 0))
    calls = []

    def kernel_step(spec_, positions, epsilon, max_iter, seed, t, ids_):
        # What the wrapper counts where it launches K10, the second check
        # and the remainder.
        calls.append((spec_, max_iter, seed, t))
        for name in mesh_kernel.CELL_STEP_LAUNCHES:
            launch_count.add(name)
        return (positions + 1, torch.zeros(n, dtype=torch.bool),
                torch.zeros(n, dtype=torch.int32))

    def no_plain_query(*args, **kwargs):
        raise AssertionError("the plain query ran on the card's path")

    monkeypatch.setattr(mesh_kernel, "mesh_step", kernel_step)
    monkeypatch.setattr(mesh_accel, "nearest_hit", no_plain_query)
    got, exc, cross = stepping.step("mesh", pos.as_subclass(_FakeCuda), spec,
                                    1e-5, 1000, 3, 5, ids)
    assert calls == [(spec, 1000, 3, 5)]
    assert torch.equal(got, pos + 1) and not exc.any() and not cross.any()
    assert mesh_kernel.CELL_STEP_LAUNCHES == ("mesh_cell", "mesh_cell_later",
                                              "mesh_bounce")
    assert launch_count.counts == dict.fromkeys(launch_count.KERNELS, 0) | {
        "mesh_cell": 1, "mesh_cell_later": 1, "mesh_bounce": 1}
    # On the card the query is the kernel's too.
    assert config.mesh_query_backend(spec, torch.float32, "cuda") == "kernel"
