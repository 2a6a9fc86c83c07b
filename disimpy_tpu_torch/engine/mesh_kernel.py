"""Nearest forward triangle hit per spin: CUDA kernels and plain version.

``nearest_hit`` answers, for every spin, the classic mesh engine's
collision query on a :class:`MeshSpec`: the closest strictly-forward
Moller-Trumbore hit along ``r0 + s * direction``, ``s`` in ``(0, rem]``
being the caller's concern. A CPU tensor goes to
:func:`nearest_hit_reference`, the gather query of ``mesh_accel`` as plain
torch; a CUDA tensor goes to a hand-written kernel of ``csrc/mesh_hit.cu``
(float32 or float64), by layout. There is no fallback from one to the
other.

- The halo layout (``spans == (1, 1, 1)``): K2 tests the records of the
  spin's halo cell. It groups the spins by cell into tiles of at most 128,
  stages each tile's row in shared memory, and splits a block's 128
  threads among the tile's spins, up to 32 lanes per spin, reducing by
  (distance, record). It is the counterpart of the JAX package's Pallas
  kernel ``engine/pallas_mesh.py::_kernel``; both read the same table, the
  Pallas kernel after a transpose that the GPU does not need.
- The per-cell layout: K10 scans the stencil of ``spans`` cells that the
  segment's bounding box overlaps, each wrapped into the voxel and tested
  at the spin's shifted position, as the JAX package's XLA stencil query
  ``engine/mesh_accel.nearest_hit`` does; up to 32 lanes per spin over
  the whole batch, reducing by (distance, cell, record).

``mesh_step`` runs one whole classic mesh step on the card, a fixed
sequence of launches with no host sync. Halo layout: the step's directions
(the draw kernel), K2 on the whole batch with the first bounce resolved in
its epilogue, then K9: the spins that still collide sorted by the halo
cell of their next segment, their second check on each cell's row staged
in shared memory (``later_pass``), the few that collide again carried
through their later bounces one warp per spin (``bounce_pass``), and a
tail that writes the positions. Per-cell layout: the directions, K10 with
the first bounce resolved, ``bounce_pass`` over the stencil for every
spin K10 lists, and the tail. It takes CUDA tensors only. Its plain
version, to which ``stepping.step`` sends CPU tensors, is
``stepping.step_mesh``, the JAX package's ``step_mesh`` while-loop
(``disimpy_tpu/engine/stepping.py:262-341``) as a Python loop.
"""

import ctypes
import math

import torch

from . import analytic_kernel, draw_kernel, launch_count, mesh_accel

# Barycentric leak-proofing tolerance per engine dtype (the JAX package's
# stepping._make_mesh_query).
EDGE_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}

# Floating-point operations of one record's Moller-Trumbore test (edges
# and offset 9, two cross products 18, det 5, reciprocal 1, t/u/v 18,
# u + v 1).
FLOPS_PER_RECORD = 52


_SYMBOLS = {torch.float32: "mesh_hit_launch_f32",
            torch.float64: "mesh_hit_launch_f64"}
_STEP_SYMBOLS = {torch.float32: "mesh_step_launch_f32",
                 torch.float64: "mesh_step_launch_f64"}
# K10, the per-cell layout's query and step.
_CELL_SYMBOLS = {torch.float32: "mesh_cell_launch_f32",
                 torch.float64: "mesh_cell_launch_f64"}
_CELL_STEP_SYMBOLS = {torch.float32: "mesh_cell_step_launch_f32",
                      torch.float64: "mesh_cell_step_launch_f64"}


def is_halo(spec):
    """Whether ``spec`` has the halo layout (one row per query)."""
    return tuple(spec.spans) == (1, 1, 1)


def halo_cells(spec, r0, direction, rem):
    """Each spin's halo cell and its position shifted into that cell's
    periodic image.

    The cell holds the minimum corner of the segment's bounding box,
    ``floor(min(r0, r0 + direction * rem) / sv_width)``, wrapped into the
    voxel; ``r0`` moves by the same whole-voxel shift. Returns (cell (n,)
    int64, shifted r0 (n, 3)).
    """
    n_sv = torch.tensor(spec.n_sv, dtype=torch.int32, device=r0.device)
    seg_end = r0 + direction * rem[:, None]
    lo = torch.minimum(r0, seg_end)
    base = torch.floor(lo / spec.sv_width).to(torch.int32)
    shift_n = torch.div(base, n_sv, rounding_mode="floor")
    wrapped = base - shift_n * n_sv
    cell = (wrapped[:, 0] * n_sv[1] + wrapped[:, 1]) * n_sv[2] + wrapped[:, 2]
    return cell.long(), r0 - shift_n.to(r0.dtype) * spec.voxel_size


def nearest_hit(spec, r0, direction, rem):
    """Closest forward hit per spin: in its halo cell (halo layout) or in
    the cells its segment's bounding box overlaps (per-cell layout).

    ``r0``, ``direction`` (n, 3) and ``rem`` (n,) are contiguous tensors
    in the spec's dtype on the spec's device. Returns ``(min_d (n,),
    normal (n, 3))``: ``inf`` and a zero normal where nothing is hit;
    equal distances resolve to the lowest record of the row (per-cell:
    of the first cell in the stencil's order); the normal's sign is
    unoriented.
    """
    kind = r0.device.type
    if kind == "cpu":
        return nearest_hit_reference(spec, r0, direction, rem)
    if kind != "cuda":
        raise ValueError(f"nearest_hit runs on cpu or cuda, not {kind}")
    return _nearest_hit_cuda(spec, r0, direction, rem)


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_spec(spec, device):
    """The spec's table geometry: (dtype, n_cells, k_pad, chunk)."""
    if min(spec.spans) < 1:
        raise ValueError(f"spec.spans {spec.spans} must be positive")
    dtype = spec.tri.dtype
    if dtype not in _SYMBOLS:
        raise ValueError(f"the mesh_hit kernel takes float32 or float64, "
                         f"not {dtype}")
    n_cells, n_chunks, chunk, _ = spec.tri.shape
    if n_cells != math.prod(spec.n_sv):
        raise ValueError(f"spec.tri has {n_cells} rows for an n_sv of "
                         f"{spec.n_sv}")
    for name, t, dt, shape in (
        ("spec.tri", spec.tri, dtype, (n_cells, n_chunks, chunk, 12)),
        ("spec.cell_counts", spec.cell_counts, torch.int32, (n_cells,)),
        ("spec.sv_width", spec.sv_width, dtype, (3,)),
        ("spec.voxel_size", spec.voxel_size, dtype, (3,)),
    ):
        _check(name, t, dt, shape, device)
    if spec.tri.data_ptr() % 16:
        raise ValueError("spec.tri must be 16-byte aligned (the kernel "
                         "stages its rows with 16-byte copies)")
    return dtype, n_cells, n_chunks * chunk, chunk


def _lib():
    from ._build import load

    lib = load("mesh_hit").lib
    for name in ("mesh_hit_scratch_words", "mesh_step_scratch_words"):
        getattr(lib, name).argtypes = [ctypes.c_int, ctypes.c_int]
        getattr(lib, name).restype = ctypes.c_longlong
    for dtype, real in ((torch.float32, ctypes.c_float),
                        (torch.float64, ctypes.c_double)):
        fn = getattr(lib, _SYMBOLS[dtype])
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [real]
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        fn = getattr(lib, _STEP_SYMBOLS[dtype])
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [real]
                       + [ctypes.c_void_p] * 5 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 9)
        fn.restype = ctypes.c_int
        fn = getattr(lib, _CELL_SYMBOLS[dtype])
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [real]
                       + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        fn = getattr(lib, _CELL_STEP_SYMBOLS[dtype])
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [real]
                       + [ctypes.c_void_p] * 5 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 9)
        fn.restype = ctypes.c_int
    return lib


def _nearest_hit_cuda(spec, r0, direction, rem):
    n = r0.shape[0]
    device = r0.device
    dtype, n_cells, k_pad, chunk = _check_spec(spec, device)
    for name, t, shape in (("r0", r0, (n, 3)), ("direction", direction,
                                                 (n, 3)), ("rem", rem, (n,))):
        _check(name, t, dtype, shape, device)
    min_d = torch.empty((n,), dtype=dtype, device=device)
    normal = torch.empty((n, 3), dtype=dtype, device=device)
    if n == 0:
        return min_d, normal
    lib = _lib()
    table = (r0.data_ptr(), direction.data_ptr(), rem.data_ptr(),
             spec.tri.data_ptr(), spec.cell_counts.data_ptr(),
             spec.sv_width.data_ptr(), spec.voxel_size.data_ptr(), n,
             *spec.n_sv)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if is_halo(spec):
            name = "mesh_hit"
            scratch = torch.empty((lib.mesh_hit_scratch_words(n, n_cells),),
                                  dtype=torch.int32, device=device)
            rc = getattr(lib, _SYMBOLS[dtype])(
                *table, k_pad, chunk, EDGE_TOL[dtype], min_d.data_ptr(),
                normal.data_ptr(), scratch.data_ptr(), stream)
        else:
            name = "mesh_cell"
            rc = getattr(lib, _CELL_SYMBOLS[dtype])(
                *table, *spec.spans, k_pad, EDGE_TOL[dtype],
                min_d.data_ptr(), normal.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launch_count.add(name)
    return min_d, normal


def mesh_step(spec, positions, epsilon, max_iter, seed, t, ids):
    """One classic mesh step on a :class:`MeshSpec` of either layout, on
    the card.

    ``positions`` (3, n) in step-length units in the spec's dtype on its
    CUDA device, ``epsilon`` a float or a one-value tensor, ``seed`` and
    ``t`` the step's draw keys (Python ints or 0-d int32 tensors on the
    device), ``ids`` the (n,) int32 spin ids. Returns ``(positions (3, n),
    exc (n,) bool, crossings (n,) int32)``: the draw kernel, then on the
    halo layout K2's passes with the first bounce resolved and K9 (the
    cell-sorted second check, then the warp-per-spin remainder), on the
    per-cell layout K10 with the first bounce resolved and the remainder
    over the stencil; the tail.
    """
    device = positions.device
    if device.type != "cuda":
        raise ValueError(f"the mesh step kernels take CUDA tensors, not "
                         f"{device}")
    dtype, n_cells, k_pad, chunk = _check_spec(spec, device)
    n = positions.shape[1]
    _check("positions", positions, dtype, (3, n), device)
    _check("ids", ids, torch.int32, (n,), device)
    perm, perm_stride = analytic_kernel.per_spin_values(
        "perm_prob", spec.perm_prob, n, dtype, device)
    eps, eps_stride = analytic_kernel.per_spin_values(
        "epsilon", epsilon, n, dtype, device)
    if perm_stride or eps_stride:
        raise ValueError("the mesh step takes one perm_prob and one epsilon "
                         "for every spin")
    directions = draw_kernel.unit_directions_epoch(seed, t, 1, ids, dtype)[0]
    r0 = positions.T.contiguous()
    direction = directions.T.contiguous()
    rem = torch.ones((n,), dtype=dtype, device=device)
    s_r0 = torch.empty_like(r0)
    s_dir = torch.empty_like(direction)
    s_rem = torch.empty_like(rem)
    iters = torch.empty((n,), dtype=torch.int32, device=device)
    crossings = torch.empty((n,), dtype=torch.int32, device=device)
    out = torch.empty((3, n), dtype=dtype, device=device)
    exc = torch.empty((n,), dtype=torch.bool, device=device)
    if n == 0:
        return out, exc, crossings
    lib = _lib()
    if is_halo(spec):
        symbol, kernels = _STEP_SYMBOLS[dtype], ("mesh_hit", "mesh_later",
                                                 "mesh_bounce")
        layout = (k_pad, chunk)
        words = lib.mesh_step_scratch_words(n, n_cells)
    else:
        symbol, kernels = _CELL_STEP_SYMBOLS[dtype], ("mesh_cell",
                                                      "mesh_bounce")
        layout = (*spec.spans, k_pad)
        words = n + 4
    scratch = torch.empty((words,), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        (p_seed, p_t), keep = draw_kernel.scalar_ptrs(device, seed, t)
        rc = getattr(lib, symbol)(
            r0.data_ptr(), direction.data_ptr(), rem.data_ptr(),
            spec.tri.data_ptr(), spec.cell_counts.data_ptr(),
            spec.sv_width.data_ptr(), spec.voxel_size.data_ptr(),
            n, *spec.n_sv, *layout, EDGE_TOL[dtype],
            ids.data_ptr(), p_seed, p_t, perm.data_ptr(), eps.data_ptr(),
            int(max_iter), s_r0.data_ptr(), s_dir.data_ptr(),
            s_rem.data_ptr(), iters.data_ptr(), crossings.data_ptr(),
            out.data_ptr(), exc.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    del keep
    if rc != 0:
        raise RuntimeError(f"mesh step kernels failed to launch: CUDA error "
                           f"{rc}")
    for name in kernels:
        launch_count.add(name)
    return out, exc, crossings


def nearest_hit_reference(spec, r0, direction, rem):
    """Plain-torch version of :func:`nearest_hit` (same arguments and
    returns): ``mesh_accel.nearest_hit`` with the dtype's edge tolerance.
    One Moller-Trumbore test per record of each visited row (padding
    records have det = 0 and never hit); the first minimum in the visiting
    order wins.
    """
    return mesh_accel.nearest_hit(spec, r0, direction, rem,
                                  edge_tol=EDGE_TOL[spec.tri.dtype])
