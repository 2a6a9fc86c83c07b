"""One J-step epoch of fused mesh physics: CUDA kernel and plain version.

``fused_epoch`` advances spins sorted by anchor cell (engine/fused.py)
through all J steps of an epoch, every bounce inside. A CUDA tensor goes to
the hand-written kernel ``csrc/fused_epoch.cu``: eight lanes per spin, lane
r folding sublane r of each unit, the group reduced by (t, r) with warp
shuffles. A CPU tensor goes to :func:`fused_epoch_reference`, the same
arithmetic as plain vectorised torch. There is no fallback from one to the
other.

The kernel is the counterpart of the JAX package's Pallas kernel
``engine/pallas_fused.py::_kernel``. Both read the records of
``FusedMeshSpec.table`` (engine/fused.py); the CUDA kernel reads them from a
quad-major copy (:func:`quad_major`) in which a spin's eight lanes find
their sixteen-byte pieces side by side.

With ``count=True`` both versions also count the fold's work, as the JAX
package's ``count_units`` variant does for its own layout: per spin the
64-triangle units it folds and the bounce passes it runs, and per warp of
``SPINS_PER_WARP`` sorted spins the unit folds the warp issues (in each
pass every spin's lanes run the largest prefix among the warp's active
spins). Units folded over units issued is the fold-lane efficiency.
"""

import ctypes
import weakref

import torch

from . import draw_kernel, krng, launch_count
from .fused import (BITS, EPS_BOUNCES, FINE_LADDER, MAX_J, _dilations)

EDGE_TOL = 1e-5  # barycentric leak-proofing tolerance (f32)
SLACK = 1e-5  # hit-acceptance slack in step lengths (f32)
# Safety margin added to a spin's reach before the ladder compare: covers
# the hit-acceptance SLACK and f32 rounding of the reach itself.
REQ_MARGIN = 0.05

# Spins per chunk of the plain version: bounds its per-pass gathers.
_CHUNK = 4096

# Spins per warp of the kernel (eight lanes each): the unit of the issued
# count.
SPINS_PER_WARP = 4
# Floating-point operations of one feature-form triangle test (det, t, u,
# v numerators: 6 + 6 + 11 + 12; one reciprocal, three products, u + v).
FLOPS_PER_TRIANGLE = 40


class EpochParams(ctypes.Structure):
    """Scalars of one launch that stay fixed over a window; field for field
    the ``EpochParams`` struct of ``csrc/fused_epoch.cu``. The RNG key, the
    first step and the valid steps are read from device memory."""

    _fields_ = [
        ("n", ctypes.c_int),
        ("J", ctypes.c_int),
        ("max_iter", ctypes.c_int),
        ("eps", ctypes.c_float),
        ("dil", ctypes.c_float * MAX_J),
        ("fine", ctypes.c_float * len(FINE_LADDER)),
    ]


def _ladder(spec, J):
    """The dilation ladder the table was packed with (same eps margin)."""
    return _dilations(J, eps_margin=EPS_BOUNCES * spec.eps_budget)


# Quad-major copies of the tables launched so far, by id of the table:
# (weak reference to the table, copy). An entry goes when its table does.
_quad_major = {}


def quad_major(table):
    """The (units, 8, 128) float32 table with each unit's floats reordered
    from (sublane r, group g, quad q, 4) to (g, q, r, 4), so that the
    kernel's eight lanes (one per sublane) read one quad of eight triangles
    as 128 contiguous bytes. Made once per table tensor and kept while it
    lives; the table is never written after the pack."""
    key = id(table)
    entry = _quad_major.get(key)
    if entry is not None and entry[0]() is table:
        return entry[1]
    copy = table.view(-1, 8, 8, 4, 4).permute(0, 2, 3, 1, 4).contiguous()
    _quad_major[key] = (weakref.ref(table), copy)
    weakref.finalize(table, _quad_major.pop, key, None)
    return copy


def fused_epoch(spec, pos_s, dirs, ids_s, start_s, packed_s, packed2_s,
                corner_s, t_base, n_valid_steps, seed32, epsilon, max_iter,
                count=False):
    """Run one epoch (J steps) of mesh physics on epoch-sorted state.

    pos_s: (3, n) float32 positions wrapped into the home periodic image;
    dirs: (J, 3, n) float32 per-step unit directions; ids_s, start_s,
    packed_s, packed2_s: (n,) int32 in the same order; corner_s: (3, n)
    float32 anchor-cell corners (the frame the table rows are stored in).
    ``t_base`` is the epoch's first absolute step, ``n_valid_steps`` how
    many of the J steps are inside the simulated window (trailing steps
    leave the spins where they are), ``seed32`` the kernel RNG key,
    ``epsilon`` the surface offset and ``max_iter`` the bounce budget.
    ``t_base``, ``n_valid_steps`` and ``seed32`` are Python ints or 0-d
    int32 tensors on the spins' device: the CUDA kernel reads them from
    device memory, so a captured graph can replay it with new values.

    Returns (per-step positions (J, 3, n) float32, iter_exc (n,) bool,
    per-step membrane-transit counts (J, n) int32); with ``count=True`` a
    fourth element ``(units, passes, issued)``: the units each spin folded
    and the bounce passes it ran over the epoch ((n,) int32 each) and the
    unit folds each warp of ``SPINS_PER_WARP`` sorted spins issued
    ((ceil(n / SPINS_PER_WARP),) int32). Counting changes no other output.
    """
    kind = pos_s.device.type
    if kind == "cpu":
        run = fused_epoch_reference
    elif kind == "cuda":
        run = _fused_epoch_cuda
    else:
        raise ValueError(f"fused_epoch runs on cpu or cuda, not {kind}")
    return run(
        spec, pos_s, dirs, ids_s, start_s, packed_s, packed2_s, corner_s,
        t_base, n_valid_steps, seed32, epsilon, max_iter, count=count,
    )


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _fused_epoch_cuda(spec, pos_s, dirs, ids_s, start_s, packed_s,
                      packed2_s, corner_s, t_base, n_valid_steps, seed32,
                      epsilon, max_iter, count=False):
    from ._build import load

    J = dirs.shape[0]
    n = pos_s.shape[1]
    device = pos_s.device
    if not 1 <= J <= MAX_J or J != spec.resort_every:
        raise ValueError(f"J = {J} does not match the spec's epoch length")
    f32, i32 = torch.float32, torch.int32
    for name, t, dtype, shape in (
        ("pos_s", pos_s, f32, (3, n)),
        ("dirs", dirs, f32, (J, 3, n)),
        ("ids_s", ids_s, i32, (n,)),
        ("start_s", start_s, i32, (n,)),
        ("packed_s", packed_s, i32, (n,)),
        ("packed2_s", packed2_s, i32, (n,)),
        ("corner_s", corner_s, f32, (3, n)),
        ("spec.table", spec.table, f32, (spec.table.shape[0], 8, 128)),
        ("spec.sv_width", spec.sv_width, f32, (3,)),
        ("spec.perm_prob", spec.perm_prob, f32, ()),
    ):
        _check(name, t, dtype, shape, device)

    out_pos = torch.empty((J, 3, n), dtype=f32, device=device)
    out_cross = torch.empty((J, n), dtype=i32, device=device)
    out_exc = torch.empty((n,), dtype=torch.bool, device=device)
    counts = ()
    if count:
        counts = (torch.empty((n,), dtype=i32, device=device),
                  torch.empty((n,), dtype=i32, device=device),
                  torch.empty((-(-n // SPINS_PER_WARP),), dtype=i32,
                              device=device))
    dil = _ladder(spec, J)
    params = EpochParams(
        n=n, J=J, max_iter=int(max_iter), eps=float(epsilon),
        dil=(ctypes.c_float * MAX_J)(*(dil + [0.0] * (MAX_J - J))),
        fine=(ctypes.c_float * len(FINE_LADDER))(*FINE_LADDER),
    )
    fn = load("fused_epoch").lib.fused_epoch_launch
    fn.argtypes = [ctypes.c_void_p] * 19 + [EpochParams, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        scalars, keep = draw_kernel.scalar_ptrs(
            device, seed32, t_base, n_valid_steps)
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(
            pos_s.data_ptr(), dirs.data_ptr(), ids_s.data_ptr(),
            start_s.data_ptr(), packed_s.data_ptr(), packed2_s.data_ptr(),
            corner_s.data_ptr(), quad_major(spec.table).data_ptr(),
            spec.sv_width.data_ptr(), spec.perm_prob.data_ptr(),
            out_pos.data_ptr(), out_cross.data_ptr(), out_exc.data_ptr(),
            *([c.data_ptr() for c in counts] if count else [None] * 3),
            *scalars, params, stream,
        )
    del keep
    if rc != 0:
        raise RuntimeError(f"fused_epoch kernel launch failed: CUDA error {rc}")
    launch_count.add("fused_epoch")
    if count:
        return out_pos, out_exc, out_cross, counts
    return out_pos, out_exc, out_cross


def threefry2x32_cuda(k0, k1, x0, x1, rounds=13):
    """The kernel's device Threefry2x32 on CUDA int32 counters (x0, x1)
    with scalar keys; returns two int32 tensors. Used to check the device
    cipher against :func:`krng.threefry2x32` bit for bit."""
    from ._build import load

    if x0.device.type != "cuda" or x0.device != x1.device:
        raise ValueError("threefry2x32_cuda takes CUDA tensors on one device")
    for t in (x0, x1):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("counters must be contiguous int32 tensors")
    if x0.shape != x1.shape:
        raise ValueError("counters must have the same shape")
    o0, o1 = torch.empty_like(x0), torch.empty_like(x1)
    fn = load("fused_epoch").lib.threefry2x32_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x0.device):
        rc = fn(
            x0.data_ptr(), x1.data_ptr(), krng.int32(k0), krng.int32(k1),
            int(rounds), x0.numel(), o0.data_ptr(), o1.data_ptr(),
            torch.cuda.current_stream(x0.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"threefry kernel launch failed: CUDA error {rc}")
    return o0, o1


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _fold_units(table, start, cnt, q, d, cc):
    """Nearest forward hit over each spin's first ``cnt`` units.

    ``start``/``cnt`` (a,) int; ``q`` (cell-local position), ``d``
    (direction) and ``cc`` (q x d) are (3, a). Returns (best t (a,), inf
    where none; unnormalised normal (3, a)). Equal t resolves to the lowest
    sublane r, then to the earliest (unit, group): per unit the lowest
    r*8 + g among the minima, and across units a later unit replaces the
    running best only if it is strictly nearer or equally near with a
    lower r.
    """
    a = start.shape[0]
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=q.device)
    best = torch.full((a,), float("inf"), dtype=torch.float32, device=q.device)
    best_r = torch.full((a,), 8, dtype=torch.int64, device=q.device)
    bn = torch.zeros((3, a), dtype=torch.float32, device=q.device)
    rg = torch.arange(64, device=q.device)  # flat (r, g) slot index
    cmax = int(cnt.max()) if a else 0
    col = [x[:, None, None] for x in (*q, *d, *cc)]
    xq, yq, zq, dx, dy, dz, ccx, ccy, ccz = col
    for c in range(cmax):
        live = c < cnt
        unit = torch.where(live, start + c, torch.zeros_like(start))
        f = table[unit.long()].reshape(a, 8, 8, 16)  # (spin, r, g, feature)
        f = [f[..., j] for j in range(16)]
        det = -(dx * f[0] + dy * f[1] + dz * f[2])
        tn = (xq * f[0] + yq * f[1] + zq * f[2]) - f[3]
        un = (ccx * f[4] + ccy * f[5] + ccz * f[6]) - (
            dx * f[7] + dy * f[8] + dz * f[9]
        )
        vn = -(ccx * f[10] + ccy * f[11] + ccz * f[12]) - (
            dx * f[13] + dy * f[14] + dz * f[15]
        )
        inv = 1.0 / det
        t = tn * inv
        u = un * inv
        v = vn * inv
        ok = (
            (det != 0) & (u >= -EDGE_TOL) & (u <= 1.0 + EDGE_TOL)
            & (v >= -EDGE_TOL) & (u + v <= 1.0 + EDGE_TOL) & (t > 0)
            & live[:, None, None]
        )
        t = torch.where(ok, t, inf).reshape(a, 64)
        t_c = t.min(dim=1).values
        slot = torch.where(t == t_c[:, None], rg, 64).min(dim=1).values
        slot = torch.where(torch.isfinite(t_c), slot, 0)
        r_c = torch.where(torch.isfinite(t_c), slot // 8, 8)
        better = (t_c < best) | ((t_c == best) & (r_c < best_r))
        n_c = torch.stack([
            fj.reshape(a, 64).gather(1, slot[:, None])[:, 0] for fj in f[:3]
        ])
        best = torch.where(better, t_c, best)
        best_r = torch.where(better, r_c, best_r)
        bn = torch.where(better[None], n_c, bn)
    return best, bn


def fused_epoch_reference(spec, pos_s, dirs, ids_s, start_s, packed_s,
                          packed2_s, corner_s, t_base, n_valid_steps,
                          seed32, epsilon, max_iter, count=False):
    """Plain-torch version of :func:`fused_epoch` (same arguments and
    returns), vectorised over spins in chunks of ``_CHUNK`` with masked
    bounce passes. Every spin still active in a pass is at the same pass
    index, which keys its permeability uniform; a warp's issued units are
    SPINS_PER_WARP times, per pass, the largest count among its active
    spins (``_CHUNK`` is a multiple of SPINS_PER_WARP, so no warp spans two
    chunks)."""
    J = dirs.shape[0]
    n = pos_s.shape[1]
    device = pos_s.device
    f32 = torch.float32
    dil = torch.tensor(_ladder(spec, J), dtype=f32, device=device)
    fine = torch.tensor(FINE_LADDER, dtype=f32, device=device)
    nf = len(FINE_LADDER)
    eps = torch.tensor(epsilon, dtype=f32, device=device)
    perm = spec.perm_prob.to(device)
    w = spec.sv_width.to(device)
    seed = krng.int32(seed32)
    t_base, n_valid_steps = int(t_base), int(n_valid_steps)
    out_pos = torch.empty((J, 3, n), dtype=f32, device=device)
    out_cross = torch.zeros((J, n), dtype=torch.int32, device=device)
    out_exc = torch.zeros((n,), dtype=torch.bool, device=device)
    i64 = torch.int64
    units = torch.zeros((n,), dtype=i64, device=device)
    passes = torch.zeros((n,), dtype=i64, device=device)
    issued = torch.zeros((-(-n // SPINS_PER_WARP),), dtype=i64, device=device)
    for lo in range(0, n, _CHUNK):
        sl = slice(lo, min(lo + _CHUNK, n))
        x = pos_s[:, sl].clone()
        corner = corner_s[:, sl]
        start, pk, pk2 = start_s[sl], packed_s[sl], packed2_s[sl]
        ids = ids_s[sl]
        m = x.shape[1]
        exc = torch.zeros((m,), dtype=torch.bool, device=device)
        w0 = lo // SPINS_PER_WARP
        warp_issued = issued[w0:w0 - (-m // SPINS_PER_WARP)]
        for s in range(J):
            if s < n_valid_steps:
                d = dirs[s][:, sl].clone()
                rem = torch.ones((m,), dtype=f32, device=device)
                iters = torch.ones((m,), dtype=torch.int32, device=device)
                crs = torch.zeros((m,), dtype=torch.int32, device=device)
                act = torch.ones((m,), dtype=torch.bool, device=device)
                it = 0
                while bool(act.any()):
                    A = act.nonzero()[:, 0]
                    xa, da, ra = x[:, A], d[:, A], rem[A]
                    q = xa - corner[:, A]
                    cc = torch.stack((
                        q[1] * da[2] - q[2] * da[1],
                        q[2] * da[0] - q[0] * da[2],
                        q[0] * da[1] - q[1] * da[0],
                    ))
                    e = torch.clamp(
                        torch.maximum(-q, q - w[:, None]), min=0.0
                    )
                    req = torch.sqrt(
                        e[0] * e[0] + e[1] * e[1] + e[2] * e[2]
                    ) + ra + REQ_MARGIN
                    lvl = (fine[:, None] < req[None]).sum(0)
                    if s:
                        lvl = lvl + (dil[:s, None] < req[None]).sum(0)
                    lvl = lvl.to(torch.int32)
                    cnt_f = (pk2[A] >> (BITS * torch.clamp(lvl, max=nf - 1))) & 63
                    cnt_c = (pk[A] >> (BITS * torch.clamp(lvl - nf, min=0))) & 63
                    cnt = torch.where(lvl < nf, cnt_f, cnt_c)
                    best, bn = _fold_units(spec.table, start[A], cnt, q, da, cc)
                    units[lo + A] += cnt
                    passes[lo + A] += 1
                    most = torch.zeros_like(warp_issued).scatter_reduce_(
                        0, A // SPINS_PER_WARP, cnt.to(i64), "amax")
                    warp_issued += SPINS_PER_WARP * most

                    hit = best <= ra + SLACK
                    rn = torch.rsqrt(torch.clamp(
                        bn[0] * bn[0] + bn[1] * bn[1] + bn[2] * bn[2],
                        min=1e-30,
                    ))
                    nx, ny, nz = bn[0] * rn, bn[1] * rn, bn[2] * rn
                    u_go = krng.bounce_uniform(seed, t_base + s, ids[A], it)
                    u_go = torch.where(perm > 0, u_go, 1.0)
                    go = u_go < perm
                    crs[A] += (hit & go).to(torch.int32)
                    bd = torch.where(hit, best, 0.0)
                    vx, vy, vz = bd * da[0], bd * da[1], bd * da[2]
                    dp = vx * nx + vy * ny + vz * nz
                    flip = torch.where(dp > 0, -1.0, 1.0)
                    nrx, nry, nrz = nx * flip, ny * flip, nz * flip
                    dp_o = -torch.abs(dp)
                    ndx = vx - 2.0 * dp_o * nrx
                    ndy = vy - 2.0 * dp_o * nry
                    ndz = vz - 2.0 * dp_o * nrz
                    nd_rn = torch.rsqrt(ndx * ndx + ndy * ndy + ndz * ndz)
                    nd = torch.stack((ndx * nd_rn, ndy * nd_rn, ndz * nd_rn))
                    ofs = torch.where(go, -eps, eps)
                    r_new = torch.stack((
                        xa[0] + vx + ofs * nrx,
                        xa[1] + vy + ofs * nry,
                        xa[2] + vz + ofs * nrz,
                    ))
                    rem_new = torch.where(hit, ra - bd, ra)
                    it_a = iters[A]
                    still = hit & (rem_new > 0) & (it_a < max_iter)
                    x[:, A] = torch.where(hit[None], r_new, xa)
                    d[:, A] = torch.where((hit & ~go)[None], nd, da)
                    rem[A] = rem_new
                    iters[A] = it_a + still.to(torch.int32)
                    act[A] = still
                    it += 1
                x = x + d * rem[None]
                exc = exc | (iters >= max_iter)
                out_cross[s, sl] = crs
            out_pos[s][:, sl] = x
        out_exc[sl] = exc
    if count:
        i32 = torch.int32
        return (out_pos, out_exc, out_cross,
                (units.to(i32), passes.to(i32), issued.to(i32)))
    return out_pos, out_exc, out_cross
