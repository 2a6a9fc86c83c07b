"""Mesh acceleration for the classic engine: packed grid and gather query.

The substrate's CSR grid is re-packed into a rectangular layout: every
subvoxel row holds a fixed number of triangle slots, and each slot holds
the full record (9 corner coordinates and the unit normal), so a spin's
candidates are one contiguous row. Padding slots are all-zero triangles,
which the Moller-Trumbore test rejects by construction (det = 0).

Periodicity: candidate subvoxel indices live on the infinite grid, are
wrapped into the voxel with a whole-voxel shift, and the spin is tested
against the wrapped subvoxel's triangles at its shifted position.

The pack is the JAX package's NumPy code unchanged, so both give the same
arrays. :func:`nearest_hit` is the plain torch query: it serves the CPU
and is the plain version of the CUDA kernels of ``engine/mesh_kernel.py``
(K2 on the halo layout, K10 on the per-cell layout).
"""

import math

import numpy as np
import torch

from . import geometry
from .specs import MeshSpec

# Above this table size the halo layout (which duplicates triangle records
# into every cell that can reach them) gives way to the per-cell layout.
HALO_BYTES_LIMIT = 512 * 1024 * 1024

# Spin-by-record elements per gather of the query: bounds its workspace.
_GATHER_ELEMENTS = 1 << 21


def _chunking(K, chunk):
    """Smallest even split of K into <= 48-wide chunks (minimal padding)."""
    if chunk is None:
        n_chunks = -(-K // 48)
        chunk = -(-K // n_chunks)
    n_chunks = -(-K // chunk)
    return chunk, n_chunks, n_chunks * chunk


def _triangle_records(substrate, scale):
    """Fused per-triangle record: 9 corner coordinates + unit normal."""
    vertices = np.asarray(substrate.vertices, dtype=np.float64) * scale
    faces = np.asarray(substrate.faces)
    tri = vertices[faces]  # (n_tris, 3, 3)
    edge1 = tri[:, 1, :] - tri[:, 0, :]
    edge2 = tri[:, 2, :] - tri[:, 0, :]
    normals = np.cross(edge1, edge2)
    norms = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = normals / np.where(norms == 0, 1.0, norms)
    return np.concatenate((tri.reshape(-1, 9), normals), axis=1)  # (n_tris, 12)


def _halo_table(counts, csr_ranges, tri_ids, record, n_sv, spans, voxel_size,
                itemsize=4):
    """Per-cell union of all triangle records reachable from a step segment
    whose AABB minimum corner lies in the cell.

    For each cell c and static offset o in the traversal stencil, the
    neighbor cell c + o (on the infinite grid) wraps into the voxel with a
    whole-voxel shift; its triangles are stored *pre-shifted* by that
    amount, so the query tests exactly one row at the spin's unshifted
    position. Duplicate (triangle, shift) pairs across offsets are removed.

    Returns (table (n_cells, K_halo, 12) float64, per-cell counts) or
    (None, None) if the table would exceed HALO_BYTES_LIMIT.
    """
    n_sv_arr = np.array(n_sv)
    n_cells = int(n_sv_arr.prod())
    cells = np.stack(
        np.meshgrid(
            np.arange(n_sv[0]), np.arange(n_sv[1]), np.arange(n_sv[2]),
            indexing="ij",
        ),
        axis=-1,
    ).reshape(-1, 3)

    entry_cell = []
    entry_tri = []
    entry_shift = []
    for off in _slot_offsets(spans):
        neighbor = cells + off[None, :]
        shift_n = neighbor // n_sv_arr
        wrapped = neighbor - shift_n * n_sv_arr
        wsv = (wrapped[:, 0] * n_sv[1] + wrapped[:, 1]) * n_sv[2] + wrapped[:, 2]
        cnt = counts[wsv]
        starts = csr_ranges[wsv, 0]
        total = int(cnt.sum())
        if total == 0:
            continue
        cell_rep = np.repeat(np.arange(n_cells), cnt)
        offsets_within = np.arange(total) - np.repeat(
            np.concatenate(([0], np.cumsum(cnt)[:-1])), cnt
        )
        entry_tri.append(tri_ids[np.repeat(starts, cnt) + offsets_within])
        entry_cell.append(cell_rep)
        entry_shift.append(np.repeat(shift_n, cnt, axis=0))
    if not entry_cell:
        return np.zeros((n_cells, 1, 12)), np.zeros(n_cells, np.int32)
    entry_cell = np.concatenate(entry_cell)
    entry_tri = np.concatenate(entry_tri)
    entry_shift = np.concatenate(entry_shift, axis=0)

    # Dedup on (cell, triangle, shift): same triangle reached through two
    # stencil offsets is one candidate; different periodic images are kept.
    n_tris = len(record)
    smin = entry_shift.min()
    srange = int(entry_shift.max() - smin + 1)
    key = ((entry_cell * n_tris + entry_tri) * srange + (entry_shift[:, 0] - smin))
    key = key * srange + (entry_shift[:, 1] - smin)
    key = key * srange + (entry_shift[:, 2] - smin)
    _, unique_idx = np.unique(key, return_index=True)
    entry_cell = entry_cell[unique_idx]
    entry_tri = entry_tri[unique_idx]
    entry_shift = entry_shift[unique_idx]

    order = np.argsort(entry_cell, kind="stable")
    entry_cell = entry_cell[order]
    per_cell = np.bincount(entry_cell, minlength=n_cells)
    K_halo = max(int(per_cell.max()), 1)
    if n_cells * K_halo * 12 * itemsize > HALO_BYTES_LIMIT:
        return None, None
    rows = record[entry_tri[order]].copy()
    shift_xyz = entry_shift[order].astype(np.float64) * voxel_size[None, :]
    rows[:, 0:9] += np.tile(shift_xyz, 3)  # shift the three corner points
    table = np.zeros((n_cells, K_halo, 12))
    slot = np.arange(len(entry_cell)) - np.repeat(
        np.concatenate(([0], np.cumsum(per_cell)[:-1])), per_cell
    )
    table[entry_cell, slot] = rows
    return table, per_cell.astype(np.int32)


def pack_mesh(substrate, scale, dtype, chunk=None, device="cpu"):
    """Build a :class:`MeshSpec` on ``device`` from a host-side mesh
    substrate.

    Two layouts are produced depending on size:

    - **halo** (preferred): each cell's row holds the deduplicated,
      pre-shifted union of every triangle a unit step segment starting in
      that cell can reach, so a collision query is a single row and
      ``spans == (1, 1, 1)``.
    - **per-cell** (when the halo table would exceed ``HALO_BYTES_LIMIT``):
      rows hold only the cell's own triangles and the query scans the
      static neighborhood stencil.

    Parameters
    ----------
    substrate : disimpy_tpu_torch.substrates._Substrate
        A substrate of type "mesh" (with CSR grid already built).
    scale : float
        Coordinate rescale factor (1 / step length in metres).
    dtype : torch.dtype
        Engine floating-point dtype (float32 or float64).
    chunk : int, optional
        Records per chunk; defaults to the smallest even split of the row
        into <= 48-wide chunks.
    device : str or torch.device, optional

    Returns
    -------
    MeshSpec
    """
    record = _triangle_records(substrate, scale)
    voxel_size = np.asarray(substrate.voxel_size, dtype=np.float64) * scale
    n_sv = tuple(int(x) for x in substrate.n_sv)

    # The engine's grid resolution is a performance choice, not physics:
    # when the user's n_sv gives cells much narrower than one step length
    # (large dt), the traversal stencil explodes as (1/width + 2)^3. Re-grid
    # the engine's acceleration structure so cells are at least half a step
    # wide; the substrate's own CSR grid (used for seeding) is untouched.
    n_cap = np.maximum(np.floor(voxel_size / 0.5).astype(int), 1)
    if np.any(np.array(n_sv) > n_cap):
        from .. import substrates as _substrates

        n_sv = tuple(int(x) for x in np.minimum(n_sv, n_cap))
        _, _, _, tri_ids, csr_ranges = _substrates._mesh_space_subdivision(
            np.asarray(substrate.vertices),
            np.asarray(substrate.faces),
            np.asarray(substrate.voxel_size),
            np.asarray(n_sv),
        )
        csr_ranges = np.asarray(csr_ranges)
        tri_ids = np.asarray(tri_ids)
    else:
        csr_ranges = np.asarray(substrate.subvoxel_indices)
        tri_ids = np.asarray(substrate.triangle_indices)

    n_subvoxels = n_sv[0] * n_sv[1] * n_sv[2]
    sv_width = voxel_size / np.array(n_sv, dtype=np.float64)
    counts = csr_ranges[:, 1] - csr_ranges[:, 0]

    # Static per-axis traversal spans: a segment of length <= 1 step plus
    # epsilon slack overlaps at most floor(1 / w) + 2 subvoxels per axis.
    spans = tuple(int(math.floor(1.0 / w)) + 2 for w in sv_width)

    halo, halo_counts = _halo_table(
        counts, csr_ranges, tri_ids, record, n_sv, spans, voxel_size,
        itemsize=torch.empty((), dtype=dtype).element_size(),
    )
    if halo is not None:
        sv_data = halo
        cell_counts = halo_counts
        spans = (1, 1, 1)
        K = sv_data.shape[1]
    else:
        cell_counts = counts.astype(np.int32)
        K = max(int(counts.max()) if counts.size else 0, 1)
        chunk_k, n_chunks, K_pad = _chunking(K, chunk)
        sv_data = np.zeros((n_subvoxels, K_pad, 12), dtype=np.float64)
        # CSR is subvoxel-major and contiguous, so one masked assignment
        # scatters every subvoxel's triangle records into its padded row.
        slot_mask = np.arange(K_pad)[None, :] < counts[:, None]
        sv_data[slot_mask] = record[tri_ids]
        K = K_pad

    chunk, n_chunks, K_pad = _chunking(K, chunk)
    if K_pad != sv_data.shape[1]:
        pad = np.zeros((n_subvoxels, K_pad - sv_data.shape[1], 12))
        sv_data = np.concatenate((sv_data, pad), axis=1)

    def tensor(a, dt):
        return torch.as_tensor(np.asarray(a)).to(dtype=dt, device=device)

    return MeshSpec(
        tri=tensor(sv_data.reshape(n_subvoxels, n_chunks, chunk, 12), dtype),
        cell_counts=tensor(cell_counts, torch.int32),
        voxel_size=tensor(voxel_size, dtype),
        sv_width=tensor(sv_width, dtype),
        perm_prob=tensor(substrate.perm_prob, dtype),
        n_sv=n_sv,
        spans=spans,
        chunk=int(chunk),
    )


def _slot_offsets(spans):
    """All (dx, dy, dz) subvoxel offsets covering the traversal box."""
    ox, oy, oz = np.meshgrid(
        np.arange(spans[0]), np.arange(spans[1]), np.arange(spans[2]), indexing="ij"
    )
    return np.stack((ox.ravel(), oy.ravel(), oz.ravel()), axis=1).astype(np.int32)


def nearest_hit(mesh: MeshSpec, r0, direction, rem, edge_tol=0.0):
    """Closest triangle intersection along each spin's remaining segment.

    Parameters
    ----------
    mesh : MeshSpec
    r0 : torch.Tensor
        (n, 3) spin positions (step-length units, possibly outside the
        voxel when periodic), on the spec's device and in its dtype.
    direction : torch.Tensor
        (n, 3) unit step directions.
    rem : torch.Tensor
        (n,) remaining step lengths.
    edge_tol : float, optional
        Barycentric edge tolerance of the triangle test (see
        geometry.ray_triangle_intersection).

    Returns
    -------
    min_d : torch.Tensor
        (n,) distance to the closest strictly-forward intersection (``inf``
        when none is found among the candidates). Equal distances resolve
        to the lowest slot of the row.
    normal : torch.Tensor
        (n, 3) unit normal of the closest triangle (zero when there is no
        hit). Its sign is unoriented.
    """
    n = r0.shape[0]
    chunk = mesh.tri.shape[2]
    block = max(1, _GATHER_ELEMENTS // chunk)
    out_d = torch.full((n,), float("inf"), dtype=r0.dtype, device=r0.device)
    out_n = torch.zeros((n, 3), dtype=r0.dtype, device=r0.device)
    offsets = torch.as_tensor(_slot_offsets(mesh.spans), device=r0.device)
    n_sv = torch.tensor(mesh.n_sv, dtype=torch.int32, device=r0.device)
    for lo_i in range(0, n, block):
        sl = slice(lo_i, min(lo_i + block, n))
        out_d[sl], out_n[sl] = _nearest_hit_block(
            mesh, r0[sl], direction[sl], rem[sl], edge_tol, offsets, n_sv,
        )
    return out_d, out_n


def _nearest_hit_block(mesh, r0, direction, rem, edge_tol, offsets, n_sv):
    """:func:`nearest_hit` on one block of spins.

    A row is visited in groups of chunks, as many as the gather budget
    holds: the first minimum within a group and a strict ``<`` across
    groups keep the lowest slot among equal distances.
    """
    n = r0.shape[0]
    dtype = r0.dtype
    n_chunks, chunk = mesh.tri.shape[1], mesh.tri.shape[2]
    group = max(1, _GATHER_ELEMENTS // (n * chunk))
    seg_end = r0 + direction * rem[:, None]
    lo = torch.minimum(r0, seg_end)
    hi = torch.maximum(r0, seg_end)
    base = torch.floor(lo / mesh.sv_width).to(torch.int32)  # (n, 3)
    upper = torch.ceil(hi / mesh.sv_width).to(torch.int32)
    upper = torch.maximum(upper, base + 1)  # never an empty range
    row_idx = torch.arange(n, device=r0.device)
    min_d = torch.full((n,), float("inf"), dtype=dtype, device=r0.device)
    normal = torch.zeros((n, 3), dtype=dtype, device=r0.device)
    for off in offsets:
        idx = base + off[None, :]  # (n, 3) infinite-grid subvoxel
        in_range = torch.all(idx < upper, dim=1)
        shift_n = torch.div(idx, n_sv, rounding_mode="floor")
        wrapped = idx - shift_n * n_sv
        sv = ((wrapped[:, 0] * n_sv[1] + wrapped[:, 1]) * n_sv[2]
              + wrapped[:, 2]).long()
        # Test the spin against the wrapped subvoxel at its shifted position.
        shifted_r0 = r0 - shift_n.to(dtype) * mesh.voxel_size
        for c in range(0, n_chunks, group):
            # (n, g * chunk, 12): contiguous row gathers.
            slab = mesh.tri[sv, c:c + group].reshape(n, -1, 12)
            tri = slab[..., :9].reshape(slab.shape[0], slab.shape[1], 3, 3)
            t = geometry.ray_triangle_intersection(
                tri, shifted_r0[:, None, :], direction[:, None, :],
                edge_tol=edge_tol,
            )
            t = torch.where(in_range[:, None] & (t > 0), t,
                            torch.full_like(t, float("inf")))
            arg = torch.argmin(t, dim=1)  # first minimum: lowest slot
            d_here = t[row_idx, arg]
            normal_here = slab[row_idx, arg, 9:12]
            better = d_here < min_d
            min_d = torch.where(better, d_here, min_d)
            normal = torch.where(better[:, None], normal_here, normal)
    return min_d, normal
