"""Plain reference of a diffusion-MRI simulation on a periodic triangle mesh.

Plain PyTorch, written for the benchmark and independent of the program: it
imports nothing of the simulator and builds its own collision grid from the
raw vertices and faces. It follows the published semantics of the
simulation that a benchmark cell runs:

- the mesh is moved so that its bounding box starts at ``padding`` from
  the origin, and the voxel is that box with ``padding`` on both sides of
  each axis, repeated periodically;
- positions are in step-length units (step length ``sqrt(6 D dt)``);
  starting positions given as an array (metres, in that voxel) are scaled
  in float64 and rounded to the configured precision;
- "uniform" seeding and every step direction come from Threefry2x32-13,
  keyed per (seed, step, spin id): seeding by ``(seed & 0x7FFFFFFF) ^
  UNIFORM_SALT`` at step 0, directions by ``(seed & 0x7FFFFFFF) ^
  ENGINE_SALT[engine]`` at step t, as isotropic Archimedes draws computed
  in the configured precision;
- a step moves each spin one step length; at the nearest forward triangle
  hit within the remaining length (plus a hit slack, barycentric edges
  widened by a tolerance) the spin reflects specularly and is moved
  ``epsilon`` off the surface, until no hit remains;
- after step t each spin's phase gains ``g_eff[t] . r(t)`` with
  ``g_eff = GAMMA dt step_l g``, and the signal is the sum over spins of
  ``cos(phase)``, leaving out spins that exhausted ``max_iter`` checks.

``epsilon``, the slack and the edge tolerance are those of the configured
precision (``cfg_dtype``); the arithmetic runs in ``dtype`` (float64 for
the reference itself; a lower precision for the control). Impermeable
meshes only.
"""

import math

import numpy as np
import torch

GAMMA = 267.513e6
UNIFORM_SALT = 0x756E6966
ENGINE_SALT = {"fused": 0x6D657368, "classic": 0x636C6173}
EDGE_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
HIT_SLACK = {torch.float32: 1e-5, torch.float64: 1e-12}
USER_EPSILON = 1e-13  # metres: the simulator's default surface offset

_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_MASK = 0xFFFFFFFF
# Spin-triangle pairs tested at once: bounds the query's workspace.
PAIR_BUDGET = 1 << 23
# Cells of the reference's collision grid, at most.
MAX_CELLS = 1 << 23
# Floating-point operations of one Moller-Trumbore record test.
FLOPS_PER_TEST = 52


def threefry2x32(k0, k1, x0, x1):
    """Threefry2x32 with 13 rounds (Salmon et al., SC'11) on int64 tensors
    holding unsigned 32-bit words; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for r in range(13):
        x0 = (x0 + x1) & _MASK
        rot = _ROTATIONS[r % 8]
        x1 = ((x1 << rot) | (x1 >> (32 - rot))) & _MASK
        x1 = x1 ^ x0
        if r % 4 == 3:
            g = r // 4 + 1
            x0 = (x0 + ks[g % 3]) & _MASK
            x1 = (x1 + ks[(g + 1) % 3] + g) & _MASK
    return x0, x1


def _uniform(word, dtype):
    return (word >> 8).to(dtype) * (1.0 / (1 << 24))


def _words(key, t, ids, draw):
    """Threefry words for key (key, t) and counter (id, draw)."""
    k0 = torch.full_like(ids, key & _MASK)
    k1 = torch.full_like(ids, t & _MASK)
    return threefry2x32(k0, k1, ids, torch.full_like(ids, draw))


def uniform_positions(seed, ids, voxel, dtype):
    """(3, n) "uniform" starting positions in the voxel (step lengths)."""
    key = (seed & 0x7FFFFFFF) ^ UNIFORM_SALT
    w0, w1 = _words(key, 0, ids, 0)
    w2, _ = _words(key, 0, ids, 1)
    u = torch.stack([_uniform(w, dtype) for w in (w0, w1, w2)])
    return u * torch.as_tensor(voxel, dtype=dtype, device=ids.device)[:, None]


def directions(key, t, ids, dtype):
    """(3, n) isotropic unit step directions (Archimedes sampling)."""
    w0, w1 = _words(key, t, ids, 0)
    z = 1.0 - 2.0 * _uniform(w0, dtype)
    rho = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = (2.0 * math.pi) * _uniform(w1, dtype)
    return torch.stack((rho * torch.cos(phi), rho * torch.sin(phi), z))


def effective_epsilon(voxel_m, scale, n_t, cfg_dtype):
    """Surface offset (step lengths): the user's 1e-13 m, floored at 64
    rounding units of the largest coordinate a periodic walk reaches."""
    magnitude = max(float(np.max(voxel_m)) * scale, 1.0)
    magnitude = max(magnitude, math.sqrt(n_t) * 3.0)
    floor = 64.0 * float(torch.finfo(cfg_dtype).eps) * magnitude
    return max(USER_EPSILON * scale, floor)


def _cross(a, b):
    return torch.stack((a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]), -1)


def _dot(a, b):
    return (a * b).sum(-1)


class Grid:
    """A uniform grid over the voxel: each cell lists every (triangle,
    periodic image) whose bounding box comes within ``reach`` of the cell,
    so a segment of length at most ``reach`` that starts in the cell can
    hit nothing else."""

    def __init__(self, tri, voxel, device, dtype, reach=1.01):
        self.voxel = torch.as_tensor(np.asarray(voxel), dtype=dtype,
                                     device=device)
        vox = np.asarray(voxel, dtype=np.float64)
        width = max(1.0, float(np.prod(vox) / MAX_CELLS) ** (1.0 / 3.0))
        n = np.maximum(np.floor(vox / width).astype(np.int64), 1)
        self.n = torch.as_tensor(n, device=device)
        self.width = torch.as_tensor(vox / n, dtype=dtype, device=device)
        t64 = torch.as_tensor(tri, dtype=torch.float64, device=device)
        a, e1, e2 = t64[:, 0], t64[:, 1] - t64[:, 0], t64[:, 2] - t64[:, 0]
        normal = _cross(e1, e2)
        normal = normal / normal.norm(dim=1, keepdim=True)
        self.a, self.e1, self.e2 = (x.to(dtype) for x in (a, e1, e2))
        self.normal = normal.to(dtype)
        lo, hi = t64.amin(dim=1), t64.amax(dim=1)
        self.box_lo, self.box_hi = lo.to(dtype), hi.to(dtype)
        shifts = torch.tensor([(i, j, k) for i in (-1, 0, 1)
                               for j in (-1, 0, 1) for k in (-1, 0, 1)],
                              dtype=torch.float64, device=device)
        shifts = shifts * torch.as_tensor(vox, device=device)
        self.shift = shifts.to(dtype)
        w64 = torch.as_tensor(vox / n, device=device)
        cells, tris, imgs = [], [], []
        for s in range(len(shifts)):
            c_lo = torch.floor((lo + shifts[s] - reach) / w64).long()
            c_hi = torch.floor((hi + shifts[s] + reach) / w64).long()
            c_lo = torch.maximum(c_lo, torch.zeros_like(c_lo))
            c_hi = torch.minimum(c_hi, self.n - 1)
            size = (c_hi - c_lo + 1).clamp(min=0)
            count = size.prod(dim=1)
            keep = count > 0
            if not bool(keep.any()):
                continue
            idx = keep.nonzero()[:, 0]
            count, size, c_lo = count[idx], size[idx], c_lo[idx]
            owner = torch.repeat_interleave(
                torch.arange(len(idx), device=device), count)
            first = torch.cumsum(count, 0) - count
            local = (torch.arange(int(count.sum()), device=device)
                     - first[owner])
            sy, sz = size[owner, 1], size[owner, 2]
            cx = c_lo[owner, 0] + local // (sy * sz)
            cy = c_lo[owner, 1] + (local // sz) % sy
            cz = c_lo[owner, 2] + local % sz
            cells.append((cx * self.n[1] + cy) * self.n[2] + cz)
            tris.append(idx[owner])
            imgs.append(torch.full_like(owner, s))
        cell = torch.cat(cells)
        order = torch.argsort(cell, stable=True)
        self.tri = torch.cat(tris)[order].to(torch.int32)
        self.img = torch.cat(imgs)[order].to(torch.int8)
        n_cells = int(np.prod(n))
        self.count = torch.bincount(cell, minlength=n_cells)
        self.start = torch.cumsum(self.count, 0) - self.count

    def cell_of(self, pos):
        """Wrapped positions (m, 3) and their cell index (m,)."""
        k = torch.floor(pos / self.voxel)
        wrapped = pos - k * self.voxel
        c = torch.floor(wrapped / self.width).long()
        c = torch.minimum(c.clamp(min=0), self.n - 1)
        return wrapped, (c[:, 0] * self.n[1] + c[:, 1]) * self.n[2] + c[:, 2]


class Work:
    """Record tests and bytes the inputs need, per step: the tests of
    every (segment, triangle) pair whose bounding boxes overlap, and each
    spin's state and each tested triangle's record moved once a step."""

    def __init__(self, n_tris, device):
        self.touched = torch.zeros(n_tris, dtype=torch.int32, device=device)
        self.tests = []
        self.records = []
        self._tests = torch.zeros((), dtype=torch.int64, device=device)

    def add(self, overlap, tri):
        """Count the pairs whose boxes overlap; mark their triangles."""
        self._tests += overlap.sum()
        self.touched.scatter_reduce_(0, tri, overlap.to(torch.int32), "amax")

    def end_step(self):
        self.tests.append(self._tests.clone())
        self.records.append((self.touched > 0).sum())
        self._tests.zero_()
        self.touched.zero_()

    def totals(self):
        return (torch.stack(self.tests).cpu().numpy(),
                torch.stack(self.records).cpu().numpy())


def _chunks(ends, m):
    """Spin ranges [lo, hi) whose pairs fit PAIR_BUDGET, with the pairs
    before each (one read of the counts from the device)."""
    total = int(ends[-1])
    if total <= PAIR_BUDGET:
        return [(0, m, 0, total)] if total else []
    ends = ends.cpu().numpy()
    out, lo = [], 0
    while lo < m:
        first = int(ends[lo - 1]) if lo else 0
        hi = int(np.searchsorted(ends, first + PAIR_BUDGET, side="right"))
        hi = min(max(hi, lo + 1), m)
        out.append((lo, hi, first, int(ends[hi - 1]) - first))
        lo = hi
    return out


def nearest_hit(grid, pos, direction, rem, edge_tol, work=None):
    """Nearest forward hit (distance, unit normal) of each segment; the
    distance is inf where the segment's line meets no candidate."""
    m = pos.shape[0]
    dtype = pos.dtype
    device = pos.device
    wrapped, cell = grid.cell_of(pos)
    count = grid.count[cell]
    start = grid.start[cell]
    best = torch.full((m,), float("inf"), dtype=dtype, device=device)
    normal = torch.zeros((m, 3), dtype=dtype, device=device)
    ends = torch.cumsum(count, 0)
    for lo, hi, first, n_pairs in (_chunks(ends, m) if m else []):
        rows = torch.arange(lo, hi, device=device)
        spin = torch.repeat_interleave(rows, count[lo:hi],
                                       output_size=n_pairs)
        local = (torch.arange(n_pairs, device=device)
                 - (ends[spin] - count[spin] - first))
        entry = start[spin] + local
        tri = grid.tri[entry].long()
        shift = grid.shift[grid.img[entry].long()]
        d = direction[spin]
        T = wrapped[spin] - (grid.a[tri] + shift)
        e1, e2 = grid.e1[tri], grid.e2[tri]
        P = _cross(d, e2)
        Q = _cross(T, e1)
        det = _dot(P, e1)
        inv = 1.0 / det
        t = inv * _dot(Q, e2)
        u = inv * _dot(P, T)
        v = inv * _dot(Q, d)
        ok = ((det != 0) & (u >= -edge_tol) & (u <= 1.0 + edge_tol)
              & (v >= -edge_tol) & (v <= 1.0 + edge_tol)
              & (u + v <= 1.0 + edge_tol) & (t > 0))
        t = torch.where(ok, t, torch.full_like(t, float("inf")))
        best.scatter_reduce_(0, spin, t, "amin")
        at_min = torch.isfinite(t) & (t == best[spin])
        pick = torch.full((m,), -1, dtype=torch.int64, device=device)
        pick.scatter_reduce_(0, spin, torch.where(at_min, tri, -1), "amax")
        chosen = pick[lo:hi]
        normal[lo:hi] = torch.where((chosen >= 0)[:, None],
                                    grid.normal[chosen.clamp(min=0)],
                                    normal[lo:hi])
        if work is not None:
            seg_end = wrapped[spin] + d * rem[spin, None]
            s_lo = torch.minimum(wrapped[spin], seg_end)
            s_hi = torch.maximum(wrapped[spin], seg_end)
            overlap = ((grid.box_lo[tri] + shift <= s_hi)
                       & (grid.box_hi[tri] + shift >= s_lo)).all(dim=1)
            work.add(overlap, tri)
    return best, normal


class Walk:
    """One simulation by the reference: ``signal`` (n_meas,) float64,
    ``positions`` (n, 3) final positions in metres, unwrapped, ``voxel``
    (3,) and ``step`` in metres, and ``work``, the per-step record tests
    and distinct triangles tested, or None."""

    def __init__(self, signal, positions, voxel, step, work):
        self.signal, self.positions = signal, positions
        self.voxel, self.step, self.work = voxel, step, work


def simulate(vertices, faces, n_walkers, diffusivity, gradient, dt, seed,
             init_pos, engine, cfg_dtype, dtype=torch.float64, device="cpu",
             max_iter=1000, work=False, padding=(0.0, 0.0, 0.0)):
    """One simulation (a ``Walk``).

    ``init_pos`` is "uniform" or an (n, 3) array of starting positions in
    metres. ``engine`` ("fused" or "classic") names the draw streams;
    ``cfg_dtype`` the configured precision (seeding, draws, epsilon, slack,
    edge tolerance); ``dtype`` the arithmetic. With ``work`` the walk also
    counts the per-step record tests and distinct triangles tested ((n_t,)
    int64 arrays).
    """
    device = torch.device(device)
    padding = np.asarray(padding, dtype=np.float64)
    vertices = np.asarray(vertices, dtype=np.float64)
    vertices = vertices - vertices.min(axis=0) + padding
    step_l = math.sqrt(6.0 * diffusivity * dt)
    scale = 1.0 / step_l
    voxel_m = vertices.max(axis=0) + padding
    voxel = voxel_m * scale
    tri = vertices[np.asarray(faces)] * scale
    n_meas, n_t, _ = gradient.shape
    eps = effective_epsilon(voxel_m, scale, n_t, cfg_dtype)
    if engine == "fused":
        eps = float(np.float32(eps))
    slack, edge_tol = HIT_SLACK[cfg_dtype], EDGE_TOL[cfg_dtype]
    grid = Grid(tri, voxel, device, dtype)
    tally = Work(len(tri), device) if work else None
    ids = torch.arange(n_walkers, dtype=torch.int64, device=device)
    if isinstance(init_pos, str):
        if init_pos != "uniform":
            raise ValueError(f"the reference does not seed {init_pos!r}")
        pos = uniform_positions(seed, ids, voxel, cfg_dtype).to(dtype).T
    else:
        pos = torch.as_tensor(np.asarray(init_pos, dtype=np.float64) * scale)
        pos = pos.to(cfg_dtype).to(dtype).to(device)
    pos = pos.contiguous()
    g_eff = (GAMMA * dt * step_l) * np.transpose(gradient, (1, 0, 2))
    g_eff = torch.as_tensor(g_eff, dtype=dtype, device=device)
    phases = torch.zeros((n_meas, n_walkers), dtype=dtype, device=device)
    exc = torch.zeros(n_walkers, dtype=torch.bool, device=device)
    key = (seed & 0x7FFFFFFF) ^ ENGINE_SALT[engine]
    for t in range(n_t):
        direction = directions(key, t, ids, cfg_dtype).to(dtype).T
        direction = direction.contiguous()
        rem = torch.ones(n_walkers, dtype=dtype, device=device)
        iters = torch.zeros(n_walkers, dtype=torch.int32, device=device)
        active = torch.arange(n_walkers, device=device)
        while active.numel():
            p, d, r = pos[active], direction[active], rem[active]
            dist, normal = nearest_hit(grid, p, d, r, edge_tol, tally)
            hit = dist <= r + slack
            v = torch.where(hit, dist, torch.zeros_like(dist))[:, None] * d
            dp = _dot(v, normal)[:, None]
            normal = torch.where(dp > 0, -normal, normal)
            new_d = v + 2.0 * dp.abs() * normal
            new_d = new_d / torch.sqrt(_dot(new_d, new_d))[:, None]
            pos[active] = torch.where(hit[:, None],
                                      p + v + eps * normal, p)
            direction[active] = torch.where(hit[:, None], new_d, d)
            r = torch.where(hit, r - dist, r)
            rem[active] = r
            it = iters[active] + 1
            iters[active] = it
            active = active[hit & (r > 0) & (it < max_iter)]
        pos = pos + direction * rem[:, None]
        exc |= iters >= max_iter
        phases += g_eff[t] @ pos.T
        if tally is not None:
            tally.end_step()
    cos = torch.where(exc[None, :], torch.zeros_like(phases),
                      torch.cos(phases))
    signal = cos.to(torch.float64).sum(dim=1).cpu().numpy()
    positions = pos.to(torch.float64).cpu().numpy() * step_l
    return Walk(signal, positions, voxel_m, step_l,
                tally.totals() if work else None)
