"""Fused-step mesh engine: anchor-keyed sorted runs + multi-bounce kernel.

The mesh hot path is organised around three ideas, the same as in the JAX
package's ``engine/fused.py``:

1. **Anchor-keyed epochs.** Spins are sorted by grid cell once per
   ``resort_every`` (J) steps. The sort key is the *anchor* cell (the cell
   at sort time), so spins of one cell stay neighbours for the whole epoch.
   Correctness comes from dilation: a cell's candidate row holds every
   triangle reachable within ``s + 1`` steps of the cell for step ``s`` of
   the epoch.

2. **Distance-ordered rows.** Each cell's candidate triangles are stored
   nearest-first, with per-step unit counts (6 bits per step, packed into
   one int32) and sub-step counts for the FINE_LADDER distances, so a spin
   folds only the prefix of its row that its remaining segment can reach.

3. **One kernel per epoch, all steps and bounces inside**
   (``engine/fused_kernel.py``): permeability uniforms come from the
   id-keyed threefry (``engine/krng.py``), so physics is independent of
   the sort order. The kernel returns per-step positions and the epoch's
   phase delta is one matrix product.

The host half (``pack_fused`` and its helpers) is the JAX package's NumPy
code unchanged, so the packed arrays are bitwise those of the JAX pack, and
its on-disk cache format is the same (in a cache directory of this
package's own). On the device, the epoch sort is one stable ``torch.sort``
of the cell keys plus index gathers, the epoch's directions one launch of
the draw kernel (``engine/draw_kernel.py``), and the kernel's per-step
positions are scattered back to canonical spin order by the same
permutation. That whole epoch is one function (:func:`epoch_body`); on a
CUDA device a window replays it as one captured CUDA graph per full epoch,
as the JAX package runs its window as one compiled program.
"""

import dataclasses
import math

import numpy as np
import torch

from . import graphs

# Per-step unit-count bit width and the maximum epoch length it allows.
BITS = 6
MAX_J = 5
# Sub-step distance thresholds (step-length units) for the FINE runtime
# ladder: bounce re-passes have remaining segments << 1 step, but the
# coarse ladder's smallest prefix is the full 1-step dilation set. Rows
# are stored distance-ordered within each cell, so the count of units
# covering each fine threshold is a valid fold prefix; 5 slots of BITS
# bits pack into one extra int32 next to cell_packed.
FINE_LADDER = (0.15, 0.3, 0.5, 0.7, 0.9)
# Triangles per table unit: one (8, 128) record block — 8 sublane-groups
# of 8 triangles, lane 16*g + j = feature j of triangle 8*g + r at
# sublane r.
UNIT_TRIS = 64
# Max units per cell row.
CH_MAX = 32
# Zero tail of the table (units). The on-disk format stores a CH_MAX tail;
# _with_tail tops it up to TAIL_UNITS, which keeps the table bitwise equal
# to the JAX package's spec (the CUDA kernel never reads past a row).
TAIL_UNITS = 256
TABLE_BYTES_LIMIT = int(1.5e9)
# Configuration-search version, stored in cached *failure* entries: a
# failure only proves no configuration fit THIS search, so a newer search
# ignores cached failures and retries.
SEARCH_VERSION = 2
# Cell widths (step lengths) the pack's search walks, wide to narrow.
WIDTH_LADDER = (30.0, 20.0, 13.5, 9.0, 6.0, 4.0, 2.83, 2.0, 1.41, 1.0, 0.71,
                0.5)
# Kernel geometry the pack's cost model was fitted with (the TPU kernel's
# lane tile and fold block). Kept so the pack picks the same configuration
# as the JAX package; refitting the model for the GPU kernel is later work.
TILE = 512
BLK = 128


def _with_tail(table):
    """Extend a packed table's CH_MAX zero tail to TAIL_UNITS units."""
    table = np.asarray(table)
    return np.concatenate(
        (table, np.zeros((TAIL_UNITS - CH_MAX, 8, 128), np.float32)),
        axis=0,
    )


@dataclasses.dataclass(frozen=True)
class FusedMeshSpec:
    """Mesh acceleration structure for the fused-step kernel.

    Attributes
    ----------
    table : torch.Tensor
        (total_units, 8, 128) float32 feature-form triangle records
        (step-length units, pre-shifted by the periodic image offset and
        translated into the owning cell's local frame — corner at the
        origin). A unit holds UNIT_TRIS = 64 triangles: sublane r, lane
        16*g + j = feature j of triangle 8*g + r, with features
        [N = E1 x E2 (0-2), A.N (3), E2 (4-6), E2 x A (7-9), E1 (10-12),
        A x E1 (13-15)] — the coefficients that turn the Moller-Trumbore
        det/t/u/v into dot products. All-zero padding slots are rejected by
        det == 0.
    cell_start : torch.Tensor
        (n_cells,) int32: first unit index of each cell's row.
    cell_packed : torch.Tensor
        (n_cells,) int32: per-step unit counts, BITS bits per epoch step
        (step s count = (packed >> (BITS*s)) & (2**BITS - 1)).
    cell_packed2 : torch.Tensor
        (n_cells,) int32: unit counts covering each FINE_LADDER distance
        threshold, BITS bits per slot (same encoding).
    voxel_size, sv_width : torch.Tensor
        (3,) float32 voxel extent / cell width (step-length units).
    perm_prob : torch.Tensor
        () float32 transmission probability per collision.
    n_sv : tuple[int, int, int]
        Cell counts.
    n_sv_t : torch.Tensor
        (3,) int32: ``n_sv`` on the spec's device, so the epoch's cell keys
        need no host copy (none is allowed inside a CUDA graph capture).
    resort_every : int
        Epoch length J (steps between sorts); also the dilation depth the
        table was built for.
    seed_salt : int
        Mixed into the kernel's RNG key so mesh draws are independent of
        the other threefry streams.
    eps_budget : float
        Largest per-collision surface offset (step-length units) whose
        worst-case accumulated drift the table's dilation margin still
        covers.
    """

    table: torch.Tensor
    cell_start: torch.Tensor
    cell_packed: torch.Tensor
    cell_packed2: torch.Tensor
    voxel_size: torch.Tensor
    sv_width: torch.Tensor
    perm_prob: torch.Tensor
    n_sv: tuple
    n_sv_t: torch.Tensor
    resort_every: int
    seed_salt: int
    eps_budget: float


_ARRAY_DTYPES = {
    "table": torch.float32,
    "cell_start": torch.int32,
    "cell_packed": torch.int32,
    "cell_packed2": torch.int32,
    "voxel_size": torch.float32,
    "sv_width": torch.float32,
    "perm_prob": torch.float32,
}


def spec_from_numpy(arrays, meta, device):
    """Build a :class:`FusedMeshSpec` on ``device`` from numpy arrays.

    ``arrays`` maps the seven array fields to numpy arrays (the ``arrays``
    dict that ``pack_fused`` caches on disk, or the fields of the JAX
    package's spec converted with ``np.asarray``); ``meta`` maps ``n_sv``,
    ``resort_every``, ``seed_salt`` and ``eps_budget``. Arrays are taken as
    they are: the table keeps whatever zero tail it has.
    """
    if set(arrays) != set(_ARRAY_DTYPES):
        raise ValueError(f"arrays must hold exactly {sorted(_ARRAY_DTYPES)}")
    tensors = {
        k: torch.tensor(np.asarray(v), dtype=_ARRAY_DTYPES[k], device=device)
        for k, v in arrays.items()
    }
    if tensors["table"].ndim != 3 or tensors["table"].shape[1:] != (8, 128):
        raise ValueError("table must have shape (units, 8, 128)")
    n_sv = tuple(int(x) for x in meta["n_sv"])
    return FusedMeshSpec(
        **tensors,
        n_sv=n_sv,
        n_sv_t=torch.tensor(n_sv, dtype=torch.int32, device=device),
        resort_every=int(meta["resort_every"]),
        seed_salt=int(meta["seed_salt"]),
        eps_budget=float(meta["eps_budget"]),
    )


# ---------------------------------------------------------------------------
# Packing (the JAX package's NumPy code, unchanged)
# ---------------------------------------------------------------------------


# Per-step collision-bounce budget the dilation margin provisions for:
# each reflection can offset a spin by up to eps along the surface normal,
# so a pathological grazing spin drifts up to EPS_BOUNCES * eps per step
# beyond its path length. Runs whose eps exceeds the provisioned budget
# need the classic engine (see the driver).
EPS_BOUNCES = 64


def _dilations(resort_every, eps_margin=0.0):
    """Dilation radius (step-length units) covering epoch step s.

    A spin is at most s steps from its anchor cell when step s starts and
    its bounce segments extend at most one more step; the 3% + 0.1 term
    absorbs float32 rounding, and ``eps_margin`` (= EPS_BOUNCES * the
    provisioned per-bounce offset) absorbs the accumulated per-bounce
    epsilon drift, which scales with geometry extent in float32.
    """
    return [(s + 1) * (1.03 + eps_margin) + 0.1 for s in range(resort_every)]


def _candidate_pairs(tri_aabb_min, tri_aabb_max, n_sv, sv_width, voxel_size,
                     dilation, periodic):
    """(triangle, periodic shift, cell) candidates by AABB overlap.

    Returns int arrays (tri_idx, shift (k, 3), cell_idx) for every pair
    whose AABBs overlap at the maximum dilation.
    """
    n_sv = np.asarray(n_sv)
    tris = []
    shifts = []
    cells = []
    if periodic:
        s_max = [1 + int(math.floor(dilation / voxel_size[a])) for a in range(3)]
        ranges = [np.arange(-s_max[a], s_max[a] + 1) for a in range(3)]
    else:
        ranges = [np.array([0])] * 3
    for sx in ranges[0]:
        for sy in ranges[1]:
            for sz in ranges[2]:
                shift = np.array([sx, sy, sz], dtype=np.float64) * voxel_size
                lo = tri_aabb_min + shift - dilation
                hi = tri_aabb_max + shift + dilation
                # Shifted triangle must reach into the voxel at all.
                ok = np.all(lo < voxel_size, axis=1) & np.all(hi > 0, axis=1)
                idx = np.nonzero(ok)[0]
                if idx.size == 0:
                    continue
                lo_c = np.clip(
                    np.floor(lo[idx] / sv_width).astype(np.int64), 0, n_sv - 1
                )
                hi_c = np.clip(
                    np.floor(hi[idx] / sv_width).astype(np.int64), 0, n_sv - 1
                )
                spans = hi_c - lo_c + 1
                count = spans.prod(axis=1)
                total = int(count.sum())
                rep = np.repeat(np.arange(idx.size), count)
                local = np.arange(total) - np.repeat(
                    np.concatenate(([0], np.cumsum(count)[:-1])), count
                )
                sy_z = spans[rep, 1] * spans[rep, 2]
                cx = lo_c[rep, 0] + local // sy_z
                rem = local % sy_z
                cy = lo_c[rep, 1] + rem // spans[rep, 2]
                cz = lo_c[rep, 2] + rem % spans[rep, 2]
                cell = (cx * n_sv[1] + cy) * n_sv[2] + cz
                tris.append(idx[rep])
                shifts.append(np.broadcast_to(
                    np.array([sx, sy, sz]), (total, 3)).copy())
                cells.append(cell)
    if not tris:
        z = np.zeros(0, dtype=np.int64)
        return z, np.zeros((0, 3), dtype=np.int64), z
    return (
        np.concatenate(tris),
        np.concatenate(shifts, axis=0),
        np.concatenate(cells),
    )


# Host-side caps for the packing search: skip grid configurations whose
# AABB-level (triangle, cell) pair count would blow pack time / RAM.
PAIR_LIMIT = int(15e6)


def quantize_n_hint(n):
    """Round an ensemble-size hint to the nearest power of two (>= 1024).

    ``pack_fused``'s cost model only needs the order of magnitude, and the
    quantization keeps the disk/driver cache keys stable across small
    changes in ``n_walkers``.
    """
    return float(2 ** round(math.log2(max(float(n), 1024.0))))


def pack_fused(substrate, scale, resort_every=4, cell_steps=None,
               bytes_limit=TABLE_BYTES_LIMIT, seed_salt=0x6D657368,
               quiet=True, cache_path=None, n_hint=2.0e5, device="cpu"):
    """Build a :class:`FusedMeshSpec` on ``device`` from a mesh substrate.

    Searches (epoch length J descending from ``resort_every``, cell width
    over a wide-to-narrow candidate ladder) for the cheapest configuration
    that fits the unit-count and memory budgets. The cost model is the JAX
    package's, fitted to its TPU kernel (per-spin cost
    ~ (1/L + 1/BLK) * (I + U * units) + C with L the run length, capped at
    TILE); it is kept so both packages choose the same configuration.

    Parameters
    ----------
    substrate : disimpy_tpu_torch.substrates._Substrate (type "mesh")
    scale : float
        1 / step length (metres^-1): converts coordinates to step units.
    resort_every : int
        Maximum epoch length J in [1, MAX_J]; reduced automatically when
        the geometry is too dense for the implied dilation.
    cell_steps : float, optional
        If given, only this cell width (in step lengths) is tried.
    n_hint : float
        Expected ensemble size: sets the runs-per-fold-block penalty
        (quantized to the nearest power of two for disk-cache stability).
    device : str or torch.device
        Where the spec's tensors live.

    Raises
    ------
    ValueError
        If no (epoch, cell width) configuration fits the budgets.
    """
    import hashlib
    import os
    import pickle

    from ..substrates import _triangle_box_overlap_batch

    n_hint_q = quantize_n_hint(n_hint)
    if cache_path is None:
        # Content-keyed disk cache: packing is a pure (and expensive)
        # function of the geometry, the step scale, and the epoch length.
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(substrate.vertices).tobytes())
        h.update(np.ascontiguousarray(substrate.faces).tobytes())
        h.update(np.asarray(
            [scale, resort_every, float(substrate.perm_prob),
             float(substrate.periodic),
             -1.0 if cell_steps is None else float(cell_steps),
             float(bytes_limit), n_hint_q, 10.0]
        ).tobytes())
        cache_dir = os.path.join(
            os.path.expanduser("~"), ".cache", "disimpy_tpu_torch"
        )
        try:
            os.makedirs(cache_dir, exist_ok=True)
            cache_path = os.path.join(
                cache_dir, f"fused-{h.hexdigest()[:24]}.pkl"
            )
        except OSError:
            cache_path = None

    if cache_path is not None and os.path.exists(cache_path):
        with open(cache_path, "rb") as f:
            parts = pickle.load(f)
        if parts.get("failed"):
            # Cached exhaustive-search failure, valid only for the SAME
            # search; a newer search retries.
            if parts.get("search_version") == SEARCH_VERSION:
                raise ValueError(
                    "fused mesh table does not fit the chunk/memory "
                    "budgets for any (epoch, cell width) configuration "
                    "(cached result)"
                )
        else:
            arrays = dict(parts["arrays"])
            arrays["table"] = _with_tail(arrays["table"])
            return spec_from_numpy(arrays, parts["meta"], device)

    if not 1 <= resort_every <= MAX_J:
        raise ValueError(f"resort_every must be in [1, {MAX_J}]")
    vertices = np.asarray(substrate.vertices, dtype=np.float64) * scale
    faces = np.asarray(substrate.faces)
    tri = vertices[faces]  # (T, 3, 3)
    voxel_size = np.asarray(substrate.voxel_size, dtype=np.float64) * scale
    aabb_min = tri.min(axis=1)
    aabb_max = tri.max(axis=1)

    # Per-bounce epsilon the dilation margin provisions for: the f32 floor
    # at the geometry's own extent, or at ~200 step-lengths of coordinate
    # magnitude (covering periodic runs up to ~4e3 steps), whichever is
    # larger.
    extent_steps = float(np.max(voxel_size))
    eps_budget = 64.0 * float(np.finfo(np.float32).eps) * max(extent_steps, 200.0)

    if cell_steps is not None:
        widths = [float(cell_steps)]
    else:
        # Wide-to-narrow: the modeled cost is unimodal in the width, so the
        # search walks downhill from wide cells and stops one step past
        # the minimum.
        widths = list(WIDTH_LADDER)
    periodic = substrate.periodic

    for J in range(resort_every, 0, -1):
        dil = _dilations(J, eps_margin=EPS_BOUNCES * eps_budget)
        best = None
        worsened = 0
        seen_n_sv = set()
        for width in widths:
            n_sv = np.maximum(1, np.floor(voxel_size / width).astype(int))
            # Several wide widths clamp to the same grid; the table only
            # depends on n_sv.
            key = tuple(int(x) for x in n_sv)
            if key in seen_n_sv:
                continue
            seen_n_sv.add(key)
            est = _pair_estimate(
                aabb_min, aabb_max, n_sv, voxel_size / n_sv, voxel_size,
                dil[-1], periodic,
            )
            if est > PAIR_LIMIT:
                continue
            built = _build_table(
                tri, aabb_min, aabb_max, n_sv, voxel_size / n_sv,
                voxel_size, dil, periodic, J, _triangle_box_overlap_batch,
            )
            if built is None:  # a per-cell chunk count overflowed
                continue
            table, cell_start, cell_packed, _ = built
            if table.nbytes > bytes_limit:
                continue
            # The JAX package's kernel cost model (device ns per
            # spin-step on its TPU), kept unchanged:
            #   cost = (1/L + 1/BLK) * (I + U * curve) + C
            curve = np.mean([
                float(np.mean((cell_packed >> (BITS * s)) & ((1 << BITS) - 1)))
                for s in range(J)
            ])
            lam = max(n_hint_q / float(np.prod(n_sv)), 1.0)
            L = min(lam, float(TILE))
            score = (1.0 / L + 1.0 / BLK) * (141.0 + curve * 434.0) + 20.0
            if not quiet:
                print(
                    f"pack_fused: J={J} width={width} n_sv={tuple(n_sv)} "
                    f"score={score:.2f} {table.nbytes/1e6:.0f}MB"
                )
            cand = (score, table.nbytes, built, key)
            if best is None or cand[:2] < best[:2]:
                best = cand
                worsened = 0
            elif score > best[0]:
                # Strictly past the (unimodal) minimum: stop the walk.
                worsened += 1
                if worsened >= 1:
                    break
        if best is not None:
            _, _, (table, cell_start, cell_packed, cell_packed2), n_sv_t = best
            arrays = {
                "table": table,
                "cell_start": cell_start,
                "cell_packed": cell_packed,
                "cell_packed2": cell_packed2,
                "voxel_size": voxel_size.astype(np.float32),
                "sv_width": (voxel_size / np.array(n_sv_t)).astype(np.float32),
                "perm_prob": np.float32(substrate.perm_prob),
            }
            meta = {
                "n_sv": n_sv_t,
                "resort_every": int(J),
                "seed_salt": int(seed_salt),
                "eps_budget": float(eps_budget),
            }
            if cache_path is not None:
                with open(cache_path, "wb") as f:
                    pickle.dump({"arrays": arrays, "meta": meta}, f)
            arrays["table"] = _with_tail(table)
            return spec_from_numpy(arrays, meta, device)
    if cache_path is not None:
        with open(cache_path, "wb") as f:
            pickle.dump(
                {"failed": True, "search_version": SEARCH_VERSION}, f
            )
    raise ValueError(
        "fused mesh table does not fit the chunk/memory budgets for any "
        "(epoch, cell width) configuration"
    )


def _pair_estimate(aabb_min, aabb_max, n_sv, sv_width, voxel_size, dilation,
                   periodic):
    """AABB-level (triangle image, cell) pair count (cheap upper bound).

    Mirrors _candidate_pairs' reachability masking: a periodic image only
    contributes the triangles whose shifted AABB actually reaches the
    dilated voxel (for dilation << voxel, that's a thin boundary shell,
    not the whole mesh 27 times over).
    """
    total = 0.0
    if periodic:
        s_max = [1 + int(math.floor(dilation / voxel_size[a])) for a in range(3)]
        if np.prod([2 * m + 1 for m in s_max]) > 4096:
            # The dilation spans many periodic tiles (step length comparable
            # to the voxel): no grid configuration is viable, and even
            # estimating it image-by-image would take minutes.
            return float("inf")
        ranges = [np.arange(-s_max[a], s_max[a] + 1) for a in range(3)]
    else:
        ranges = [np.array([0])] * 3
    for sx in ranges[0]:
        for sy in ranges[1]:
            for sz in ranges[2]:
                shift = np.array([sx, sy, sz], dtype=np.float64) * voxel_size
                lo = aabb_min + shift - dilation
                hi = aabb_max + shift + dilation
                ok = np.all(lo < voxel_size, axis=1) & np.all(hi > 0, axis=1)
                if not np.any(ok):
                    continue
                lo_c = np.clip(np.floor(lo[ok] / sv_width), 0, n_sv - 1)
                hi_c = np.clip(np.floor(hi[ok] / sv_width), 0, n_sv - 1)
                total += float(np.prod(hi_c - lo_c + 1, axis=1).sum())
    return total


def _build_table(tri, aabb_min, aabb_max, n_sv, sv_width, voxel_size, dil,
                 periodic, J, sat_batch):
    """Distance-ordered per-cell rows; None if a count overflows BITS."""
    tri_i, shift_i, cell_i = _candidate_pairs(
        aabb_min, aabb_max, n_sv, sv_width, voxel_size, dil[-1], periodic
    )
    n_cells = int(np.prod(n_sv))
    if len(tri_i) == 0:
        table = np.zeros((1, 8, 128), np.float32)
        z = np.zeros(n_cells, np.int32)
        return table, z, z.copy(), z.copy()

    # Membership: exact SAT against the largest dilated cell box (one
    # pass). Level (which epoch step first needs the triangle): from the
    # AABB distance between triangle and cell box — a lower bound on the
    # true distance, so a triangle can only land in an *earlier* chunk
    # than strictly necessary (superset per step = no leaks), while the
    # exact per-level SAT cascade would cost J passes of host time.
    cell_xyz = np.stack(
        np.unravel_index(cell_i, tuple(n_sv)), axis=1
    ).astype(np.float64)
    box_lo = cell_xyz * sv_width
    box_hi = box_lo + sv_width
    tri_shifted = tri[tri_i] + (shift_i * voxel_size)[:, None, :]
    keep = np.empty(len(tri_i), dtype=bool)
    for c0 in range(0, len(tri_i), 2_000_000):
        sl = slice(c0, c0 + 2_000_000)
        boxes = np.stack(
            (box_lo[sl] - dil[-1], box_hi[sl] + dil[-1]), axis=1
        )
        keep[sl] = sat_batch(tri_shifted[sl], boxes)
    tri_i, cell_i = tri_i[keep], cell_i[keep]
    tri_shifted = tri_shifted[keep]
    box_lo, box_hi = box_lo[keep], box_hi[keep]
    amin = tri_shifted.min(axis=1)
    amax = tri_shifted.max(axis=1)
    gap = np.maximum(np.maximum(box_lo - amax, amin - box_hi), 0.0)
    dist_lb = np.linalg.norm(gap, axis=1)
    level = np.searchsorted(np.asarray(dil), dist_lb, side="left")
    level = np.minimum(level, J - 1).astype(np.int32)

    # Rows inside a cell are DISTANCE-ordered (nearest-first). Sorting by
    # the exact dist_lb (a refinement of sorting by level, since level is
    # monotone in dist_lb) makes the unit count covering ANY distance
    # threshold a valid fold prefix — the step ladder and the sub-step
    # FINE_LADDER both index prefixes of the same stream.
    order = np.lexsort((dist_lb, cell_i))
    cell_i, level, tri_shifted = cell_i[order], level[order], tri_shifted[order]
    dist_lb = dist_lb[order]
    per_cell = np.bincount(cell_i, minlength=n_cells)

    # Per-cell, per-step unit counts (UNIT_TRIS triangles per unit).
    counts = np.zeros((n_cells, J), np.int64)
    for s in range(J):
        c = np.bincount(cell_i[level <= s], minlength=n_cells)
        counts[:, s] = -(-c // UNIT_TRIS)
        # a row's step-s stream must include every earlier-step unit
        if s:
            counts[:, s] = np.maximum(counts[:, s], counts[:, s - 1])
    if counts.max() > CH_MAX:
        return None
    packed = np.zeros(n_cells, np.int64)
    for s in range(J):
        packed |= counts[:, s] << (BITS * s)
    # Fine (sub-step) prefix counts: units covering each FINE_LADDER
    # distance; always a subset of the step-0 prefix (dist < dil[0]).
    packed2 = np.zeros(n_cells, np.int64)
    for k, fk in enumerate(FINE_LADDER):
        c = np.bincount(cell_i[dist_lb <= fk], minlength=n_cells)
        packed2 |= (-(-c // UNIT_TRIS)) << (BITS * k)

    n_units_cell = counts[:, J - 1]
    cell_start = np.concatenate(([0], np.cumsum(n_units_cell)[:-1]))
    total_units = max(int(n_units_cell.sum()), 1)
    if total_units * 8 * 128 * 4 > 4 * TABLE_BYTES_LIMIT:
        # Don't even allocate tables that can't fit any budget (the caller
        # checks the exact limit on the returned table).
        return None

    # Feature-form records (see csrc/fused_epoch.cu): det, t, u, v of
    # Moller-Trumbore become dot products of per-spin features against
    # [N = E1 x E2 (raw), A.N, E2, E2 x A, E1, A x E1] — 16 values exactly.
    # All-zero padding slots give N = 0 => det = 0 => rejected.
    # CELL-LOCAL frame: the affine features subtract the owning cell's
    # corner so their magnitudes are bounded by the cell width plus the
    # dilation (f32-safe for any voxel extent); the kernel re-offsets each
    # run's spins by the same corner (the epoch driver's corner_s).
    # Recomputed from the SORTED cell_i (box_lo predates the lexsort).
    corner = np.stack(
        np.unravel_index(cell_i, tuple(n_sv)), axis=1
    ).astype(np.float64) * sv_width
    tri_local = tri_shifted - corner[:, None, :]
    A = tri_local[:, 0, :]
    E1 = tri_local[:, 1, :] - A
    E2 = tri_local[:, 2, :] - A
    N = np.cross(E1, E2)
    AN = np.sum(A * N, axis=1, keepdims=True)
    EA = np.cross(E2, A)
    AE = np.cross(A, E1)
    rec = np.concatenate((N, AN, E2, EA, E1, AE), axis=1).astype(np.float32)

    row_start = np.concatenate(([0], np.cumsum(per_cell)[:-1]))
    slot = np.arange(len(cell_i)) - row_start[cell_i]
    flat = cell_start[cell_i] * UNIT_TRIS + slot  # slot in the unit stream
    flat_arr = np.zeros((total_units * UNIT_TRIS, 16), np.float32)
    flat_arr[flat] = rec
    # Unit layout (csrc/fused_epoch.cu): local triangle t = 8*g + r
    # lands at sublane r, lanes [16*g, 16*g + 16).
    table = np.ascontiguousarray(
        flat_arr.reshape(total_units, 8, 8, 16)
        .transpose(0, 2, 1, 3)
        .reshape(total_units, 8, 128)
    )
    # Trailing zero units (on-disk format: CH_MAX; _with_tail extends to
    # TAIL_UNITS at spec construction, as the JAX package's spec has it).
    table = np.concatenate(
        (table, np.zeros((CH_MAX, 8, 128), np.float32)), axis=0
    )
    return (table, cell_start.astype(np.int32), packed.astype(np.int32),
            packed2.astype(np.int32))


# ---------------------------------------------------------------------------
# Window execution
# ---------------------------------------------------------------------------


def _cell_keys(spec, positions):
    """Anchor keys and per-spin row metadata from true (3, n) positions."""
    n_sv = spec.n_sv_t[:, None]
    base = torch.floor(positions / spec.sv_width[:, None]).to(torch.int32)
    shift = torch.div(base, n_sv, rounding_mode="floor")
    wrapped = base - shift * n_sv
    cell = (wrapped[0] * spec.n_sv[1] + wrapped[1]) * spec.n_sv[2] + wrapped[2]
    shiftvox = shift.to(positions.dtype) * spec.voxel_size[:, None]
    idx = cell.long()
    return (cell, spec.cell_start[idx], spec.cell_packed[idx],
            spec.cell_packed2[idx], shiftvox)


def epoch_inputs(spec, positions, ids, t_base, seed_k):
    """Sort spins by anchor cell and build the kernel's inputs for one epoch.

    ``positions`` (3, n) float32 true coordinates and ``ids`` (n,) int32
    spin ids; ``t_base`` the epoch's first step and ``seed_k`` the kernel
    RNG key (simulation seed ^ salt), Python ints or 0-d int32 tensors on
    the spins' device. Returns ``(order, shiftvox_s, inputs)``: the stable
    sort permutation, the sorted periodic-image offsets (3, n), and the
    tuple ``(pos_s, dirs, ids_s, start_s, packed_s, packed2_s, corner_s)``
    of :func:`fused_kernel.fused_epoch` arguments in sorted order. The
    epoch's directions are one call of the draw kernel
    (``engine/draw_kernel.py``).
    """
    from . import draw_kernel

    J = spec.resort_every
    n1n2 = spec.n_sv[1] * spec.n_sv[2]
    cell, start, packed, packed2, shiftvox = _cell_keys(spec, positions)
    order = torch.sort(cell, stable=True).indices
    cell_s = cell[order]
    ids_s = ids[order]
    # Anchor-cell corners (the table rows' coordinate frame).
    cxi = torch.div(cell_s, n1n2, rounding_mode="floor")
    rem_c = cell_s - cxi * n1n2
    cyi = torch.div(rem_c, spec.n_sv[2], rounding_mode="floor")
    czi = rem_c - cyi * spec.n_sv[2]
    corner_s = (
        torch.stack((cxi, cyi, czi)).to(torch.float32) * spec.sv_width[:, None]
    )
    # Per-step unit directions for the whole epoch (id-keyed streams).
    dirs = draw_kernel.unit_directions_epoch(seed_k, t_base, J, ids_s)
    inputs = (
        (positions - shiftvox)[:, order].contiguous(), dirs, ids_s,
        start[order].contiguous(), packed[order].contiguous(),
        packed2[order].contiguous(), corner_s,
    )
    return order, shiftvox[:, order], inputs


@dataclasses.dataclass
class EpochState:
    """What one epoch reads and updates in place, in canonical spin order.

    ``positions`` (3, n) float32 true coordinates, ``ids`` (n,) int32 spin
    ids, ``iter_exc`` (n,) bool; ``scalars`` (4,) int32: the kernel RNG key
    (simulation seed ^ salt), the epoch's first step, its steps inside the
    window and its index, which :func:`epoch_body` advances by ``advance``
    ((0, J, 0, 1)) at its end. Optional: ``phases`` (n_meas, n) with ``g``
    (n_epochs, n_meas, 3J), the window's phase coefficients per epoch;
    ``compartments`` (crossings, parity, intra_steps); ``counts`` (3,)
    int64, the counting kernel's sums.
    """

    positions: torch.Tensor
    ids: torch.Tensor
    iter_exc: torch.Tensor
    scalars: torch.Tensor
    advance: torch.Tensor
    phases: torch.Tensor = None
    g: torch.Tensor = None
    compartments: tuple = None
    counts: torch.Tensor = None

    @classmethod
    def like(cls, J, positions, iter_exc, phases=None, g=None,
             compartments=None, count=False):
        """Empty buffers of the given tensors' shapes and devices."""
        from .draw_kernel import device_scalars

        device = positions.device
        opt = (lambda t: None if t is None else torch.empty_like(t))
        return cls(
            positions=torch.empty_like(positions),
            ids=torch.empty(positions.shape[1], dtype=torch.int32,
                            device=device),
            iter_exc=torch.empty_like(iter_exc),
            scalars=torch.empty(4, dtype=torch.int32, device=device),
            advance=device_scalars((0, J, 0, 1), device),
            phases=opt(phases), g=opt(g),
            compartments=None if compartments is None else tuple(
                torch.empty_like(c) for c in compartments),
            counts=(torch.empty(3, dtype=torch.int64, device=device)
                    if count else None),
        )

    def load(self, positions, ids, iter_exc, seed_k, t0, J, phases=None,
             g=None, compartments=None):
        """Copy a window's start into the buffers, with the scalars
        (seed_k, t0, J, 0) and the counts at zero."""
        from .draw_kernel import device_scalars

        device = self.positions.device
        self.positions.copy_(positions)
        self.ids.copy_(ids)
        self.iter_exc.copy_(iter_exc)
        self.scalars.copy_(device_scalars((seed_k, t0, J, 0), device))
        for mine, theirs in ((self.phases, phases), (self.g, g)):
            if mine is not None:
                mine.copy_(theirs)
        if self.compartments is not None:
            for mine, theirs in zip(self.compartments, compartments):
                mine.copy_(theirs)
        if self.counts is not None:
            self.counts.zero_()


def epoch_body(spec, st, n_valid, epsilon, max_iter):
    """Run one epoch on the :class:`EpochState` ``st``, in place.

    Sorts the spins by anchor cell, draws the epoch's directions (one
    draw-kernel call), runs the epoch kernel, scatters its per-step
    positions, iter_exc and transits back to canonical order by the sort
    permutation, and folds them into ``st``: iter_exc ``|=``, the phase
    delta ``g[epoch] @ steps`` (one (n_meas, 3J) x (3J, n) product, the
    epoch's coefficients read through the device index), the trackers
    (:func:`fold_transits`) and the counts; then the next epoch's start
    positions, and the scalars advance. ``n_valid`` (a Python int) must
    equal ``st.scalars[2]``.

    Nothing here syncs the host or copies from host memory, so one call
    can be captured into a CUDA graph and replayed (:func:`run_window_fused`).

    Returns the epoch's per-step true positions (J, 3, n), its iter_exc
    (n,) and transits (J, n), all in canonical order, and its fold counts
    summed over the spins ((3,) int64) or None when ``st`` counts nothing.
    """
    from . import fused_kernel

    J = spec.resort_every
    seed_k, t_base = st.scalars[0], st.scalars[1]
    order, shiftvox_s, inputs = epoch_inputs(
        spec, st.positions, st.ids, t_base, seed_k)
    pos_steps, exc_s, cross_s, *counts = fused_kernel.fused_epoch(
        spec, *inputs, t_base, st.scalars[2], seed_k, epsilon, max_iter,
        count=st.counts is not None,
    )
    steps = torch.empty_like(pos_steps)
    steps[:, :, order] = pos_steps + shiftvox_s[None]
    exc = torch.empty_like(exc_s)
    exc[order] = exc_s
    cross = torch.empty_like(cross_s)
    cross[:, order] = cross_s
    st.iter_exc |= exc
    if st.phases is not None:
        g = st.g.index_select(0, st.scalars[3:])[0]
        st.phases += g @ steps.reshape(3 * J, -1)
    if st.compartments is not None:
        for mine, new in zip(st.compartments,
                             fold_transits(st.compartments, cross, n_valid)):
            mine.copy_(new)
    epoch_counts = None
    if st.counts is not None:
        epoch_counts = torch.stack(
            [c.sum(dtype=torch.int64) for c in counts[0]])
        st.counts += epoch_counts
    st.positions.copy_(steps[-1])
    st.scalars += st.advance
    return steps, exc, cross, epoch_counts


def _set_valid(st, n_valid, J):
    """Point ``st.scalars[2]`` at a trailing partial epoch's steps."""
    if n_valid != J:
        st.scalars[2:3].fill_(n_valid)


def epochs(spec, positions, ids, t0, n_t, seed_k, epsilon, max_iter,
           count=False):
    """Run the steps t0 .. t0 + n_t - 1 epoch by epoch (:func:`epoch_body`,
    eagerly).

    ``positions`` (3, n) float32 true coordinates and ``ids`` (n,) int32
    spin ids (they key each spin's streams) on the spec's device;
    ``seed_k`` the kernel RNG key (simulation seed ^ salt). Yields, per
    epoch, the per-step true positions (J, 3, n), the epoch's iter_exc
    (n,) bool and the per-step membrane transits (J, n) int32, all in the
    order of ``positions``, and the number of the epoch's steps inside the
    window. Steps past the window in the trailing partial epoch repeat the
    last position and count no transit. With ``count=True`` each epoch also
    yields, last, the kernel's fold counts summed over the spins: a (3,)
    int64 tensor of units folded, bounce passes and units issued
    (``fused_kernel.fused_epoch``).
    """
    J = spec.resort_every
    exc0 = torch.zeros(positions.shape[1], dtype=torch.bool,
                       device=positions.device)
    st = EpochState.like(J, positions, exc0, count=count)
    st.load(positions, ids, exc0, seed_k, t0, J)
    for t_base in range(t0, t0 + n_t, J):
        n_valid = min(t0 + n_t - t_base, J)
        _set_valid(st, n_valid, J)
        steps, exc, cross, counts = epoch_body(
            spec, st, n_valid, epsilon, max_iter)
        yield (steps, exc, cross, n_valid) + ((counts,) if count else ())


def fold_transits(compartments, cross, n_valid):
    """Fold one epoch's per-step transits (J, n) into the trackers.

    ``compartments`` is ``(crossings, parity, intra_steps)`` (see
    ``engine/core.run_window``). A spin dwells step s in the compartment
    it ends step s in: its parity after step s is the starting parity
    plus the inclusive prefix sum of its transits. Steps from ``n_valid``
    on add nothing.
    """
    crossings, parity, intra = compartments
    prefix = torch.cumsum(cross, dim=0, dtype=torch.int32)
    after = (parity.to(torch.int32)[None, :] + prefix[:n_valid]) & 1
    return (crossings + prefix[n_valid - 1],
            (after[-1] != 0),
            intra + after.sum(dim=0, dtype=torch.int32))


# Captured epochs by id of their spec, then by window shape
# (engine/graphs.py).
_GRAPHS = {}


def _epoch_graph(spec, key, make_state):
    return graphs.cached(_GRAPHS, spec, key, make_state)


def run_window_fused(spec, positions, phases, iter_exc, g_eff, ts, seed32,
                     epsilon, max_iter, id_base=0, track=False,
                     compartments=None, count=False):
    """Advance the ensemble through the window ``ts`` with the fused engine.

    ``positions`` (3, n) are true unwrapped coordinates (step-length units),
    ``phases`` (n_meas, n), ``iter_exc`` (n,) bool and ``g_eff``
    (len(ts), n_meas, 3), all float32 tensors on the spec's device. ``ts``
    is a sequence of consecutive absolute step indices. ``seed32`` is an
    int32-range value derived from the simulation seed; the kernel's RNG is
    keyed by (seed32 ^ salt, t, spin id). ``id_base`` offsets the spin ids
    (a split run passes each part's global offset so every spin keeps its
    stream).

    With ``track=True``, ``compartments`` is the ``(crossings, parity,
    intra_steps)`` tuple of ``engine/core.run_window``; the kernel's
    per-step transit counts are folded into it epoch by epoch
    (:func:`fold_transits`) and the window returns it as a third element.

    With ``count=True`` the kernel's fold counts are summed over the
    window's epochs into a (3,) int64 tensor (units folded, bounce passes,
    units issued; see :func:`epochs`), returned last. int64 keeps a long
    window from overflowing (the JAX package sums them in int32).

    Every epoch is one :func:`epoch_body`. On a CUDA device with
    ``config.fused_cuda_graph`` (the default) the full epochs are replays
    of one captured CUDA graph, kept per (spec, spins, measurements,
    epochs, id_base, epsilon, max_iter, track, count) for the spec's
    ``graphs.GRAPHS_PER_SPEC`` most recent shapes, so no Python runs between
    their kernels; a trailing partial epoch runs
    eagerly. Otherwise, and on the CPU, every epoch runs eagerly. Both give
    the same values bit for bit. The arguments are not modified.

    Returns ``(positions, phases, iter_exc)`` [, compartments] [, counts].
    """
    from . import config
    from .core import require_full_fp32

    require_full_fp32()
    if track and (compartments is None or len(compartments) != 3):
        raise ValueError("track=True needs compartments = (crossings, "
                         "parity, intra_steps)")
    J = spec.resort_every
    n = positions.shape[1]
    n_t = len(ts)
    m = phases.shape[0]
    # Pad the window's phase coefficients to whole epochs (zero rows
    # accumulate zero delta for the trailing partial epoch).
    n_full = n_t // J
    n_epochs = -(-n_t // J)
    g_pad = torch.zeros((n_epochs * J, m, 3), dtype=g_eff.dtype,
                        device=g_eff.device)
    g_pad[:n_t] = g_eff
    g_flat = g_pad.reshape(n_epochs, J, m, 3).permute(0, 2, 1, 3).reshape(
        n_epochs, m, 3 * J)
    compartments = compartments if track else None

    def make_state():
        return EpochState.like(J, positions, iter_exc, phases, g_flat,
                               compartments, count)

    graphed = (positions.device.type == "cuda" and config.fused_cuda_graph
               and n_full > 0)
    if graphed:
        entry = _epoch_graph(spec, (
            n, m, n_epochs, int(id_base), float(epsilon), int(max_iter),
            track, count), make_state)
        entry.lock.acquire()
        st = entry.state
    else:
        st = make_state()
    try:
        ids = id_base + torch.arange(n, dtype=torch.int32,
                                     device=positions.device)
        st.load(positions, ids, iter_exc, int(seed32) ^ spec.seed_salt,
                int(ts[0]), J, phases, g_flat, compartments)
        done = 0
        if graphed:
            from . import fused_kernel

            # K1's quad-major table copy is made once, outside the capture.
            entry.run(lambda: epoch_body(spec, st, J, epsilon, max_iter),
                      n_full, prepare=lambda: fused_kernel.quad_major(
                          spec.table))
            done = n_full
        for e in range(done, n_epochs):
            n_valid = min(n_t - e * J, J)
            _set_valid(st, n_valid, J)
            epoch_body(spec, st, n_valid, epsilon, max_iter)
        out = [st.positions, st.phases, st.iter_exc]
        if track:
            out.append(st.compartments)
        if count:
            out.append(st.counts)
        if graphed:
            # The static buffers serve the next window of this shape.
            out = [tuple(t.clone() for t in o) if isinstance(o, tuple)
                   else o.clone() for o in out]
        return tuple(out)
    finally:
        if graphed:
            entry.lock.release()
