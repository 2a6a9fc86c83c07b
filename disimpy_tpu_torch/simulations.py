"""Diffusion-weighted MR simulation driver (PyTorch).

``simulation(...)`` takes the JAX package's signature plus ``device``.
It runs, in float32 or float64, with or without trajectory output:

- free diffusion (``substrates.free()``);
- spheres, infinite cylinders and ellipsoids, through the classic engine
  (``engine/core.run_window`` and ``engine/stepping.py``), in the
  substrate's own frame;
- triangle meshes, seeded "uniform" (on the device), "intra"/"extra"
  (host ray-parity sampling) or from an explicit array. Float32 runs
  without trajectory output go through the fused epoch engine
  (``engine/fused.py``, CUDA kernel ``csrc/fused_epoch.cu``); the rest,
  and runs whose geometry or surface offset the fused table cannot serve,
  go through the classic per-bounce engine, whose collision query is the
  CUDA kernel ``csrc/mesh_hit.cu`` on the halo layout.

Compartment tracking (``exchange_stats=True``, a two-compartment
``relaxation`` pair) runs on both engines; ``devices=`` splits the spins
into contiguous parts, one per device, run concurrently
(``parallel/sharding.py``).

With ``engine.config.fused_count_units = True`` a single-part fused run
resets ``_STREAM_DIAG`` and fills it with the epoch kernel's fold counts,
summed over every spin, step and bounce pass of the run:

- ``_STREAM_DIAG[0]``: 64-triangle units folded. Triangles tested per
  spin-step = 64 * diag[0] / (n_walkers * n_t).
- ``_STREAM_DIAG[1]``: bounce passes. Passes per spin-step = diag[1] /
  (n_walkers * n_t).
- ``_STREAM_DIAG[2]``: unit folds issued: per pass, each warp of four
  sorted spins runs the largest prefix among its active spins in all four
  spins' lanes. Fold-lane efficiency = diag[0] / diag[2] (at most 1).

The JAX package's slots count its TPU kernel's 128-lane blocks instead:
[units folded per 128-lane block, gated block-passes, live-lane-weighted
units]. Its "streamed tris/spin-step" (64 * 128 * diag[0] / (n * n_t))
counts every lane of a block that folds a unit, so it is nearer the port's
issued triangles per spin-step (64 * diag[2] / (n * n_t)) than its
triangles tested, and neither is the same quantity. A
classic run, a run handed over to the classic engine, a split run and a
run with counting off leave ``_STREAM_DIAG`` as it was (the JAX package's
rule).

All geometry is rescaled to step-length units. Randomness is the
counter-based threefry of ``engine/krng.py``, keyed per (seed, step, spin
id); host-side seeding uses the same numpy RNG calls as the JAX package, so
analytic and "intra"/"extra" seeds equal its seeds bit for bit.
"""

import dataclasses
import math
import warnings

import numpy as np
import torch

from . import parallel, substrates, utils
from .engine import core as engine_core
from .engine import krng
from .engine.specs import CylinderSpec, EllipsoidSpec, FreeSpec, SphereSpec
from .gradients import GAMMA

__all__ = ["simulation", "add_noise_to_data"]

# Mixed into the simulation seed for device-side "uniform" mesh seeding.
UNIFORM_SALT = 0x756E6966

# Fold counts of the last counted fused run: [units folded, bounce passes,
# units issued] (module docstring).
_STREAM_DIAG = [0, 0, 0]


# ---------------------------------------------------------------------------
# Host-side initial-position samplers (NumPy, seeded for parity with the
# JAX package).
# ---------------------------------------------------------------------------


def _rejection_fill(n, proposal, accept):
    """Vectorized rejection sampling: draw batches with ``proposal(k)``,
    keep rows passing ``accept``, until ``n`` accepted points exist.
    Batch sizes adapt to the observed acceptance rate (which can be <1%
    when seeding thin compartments such as the interior of a neuron mesh).
    """
    accepted = []
    got = 0
    proposed = 0
    kept = 0
    while got < n:
        if proposed == 0:
            k = max(n - got, 1) * 2
        else:
            rate = max(kept / proposed, 1.0 / proposed, 1e-4)
            k = int(min(max((n - got) / rate * 1.2, 1024), 2**21))
        batch = proposal(k)
        keep = batch[accept(batch)]
        proposed += k
        kept += len(keep)
        accepted.append(keep)
        got += len(keep)
    return np.concatenate(accepted, axis=0)[:n]


def _fill_ellipsoid(n, semiaxes):
    """Sample n points uniformly inside an axis-aligned ellipsoid."""
    semiaxes = np.asarray(semiaxes, dtype=float)
    return _rejection_fill(
        n,
        lambda k: (np.random.random((k, 3)) - 0.5) * 2 * semiaxes,
        lambda p: np.sum((p / semiaxes) ** 2, axis=1) < 1,
    )


def _fill_sphere(n, radius):
    """Sample n points uniformly inside a sphere of the given radius.

    The equal-semiaxes ellipsoid case, so that sphere and ellipsoid
    simulations with the same seed draw identical initial positions.
    """
    return _fill_ellipsoid(n, np.array([radius, radius, radius]))


def _fill_circle(n, radius):
    """Sample n points uniformly inside a circle of the given radius."""
    return _rejection_fill(
        n,
        lambda k: (np.random.random((k, 2)) - 0.5) * 2 * radius,
        lambda p: np.linalg.norm(p, axis=1) < radius,
    )


def _initial_positions_cylinder(n_walkers, radius, R):
    """Uniform points on the x=0 disc of a cylinder, rotated to the lab
    frame by R (cylinder frame -> lab frame)."""
    positions = np.zeros((n_walkers, 3))
    positions[:, 1:3] = _fill_circle(n_walkers, radius)
    return positions @ np.asarray(R).T


def _initial_positions_ellipsoid(n_walkers, semiaxes, R):
    """Uniform points inside an ellipsoid, rotated to the lab frame by R
    (ellipsoid frame -> lab frame)."""
    return _fill_ellipsoid(n_walkers, semiaxes) @ np.asarray(R).T


def _count_crossings_x(points, triangles, candidates):
    """Number of candidate triangles crossed by the +x ray from each point.

    ``points`` (n, 3) and ``triangles`` (m, 3, 3) float32 tensors;
    ``candidates`` (n, K) int64 triangle indices per point, -1-padded. Each
    id appears at most once per point, so parity needs no dedup.
    """
    from .engine import geometry

    sel = triangles[torch.clamp(candidates, min=0)]  # (n, K, 3, 3)
    ray = torch.zeros_like(points)
    ray[:, 0] = 1.0
    t = geometry.ray_triangle_intersection(
        sel, points[:, None, :], ray[:, None, :]
    )
    hit = (candidates >= 0) & (t > 0)
    return hit.sum(dim=1)


def _column_candidates(substrate, n_faces):
    """Per-(y, z)-grid-column candidate triangle lists for +x parity rays.

    A +x ray from any point only crosses triangles that overlap its (y, z)
    column of the acceleration grid, so the per-point candidate set shrinks
    from all triangles to the column's deduplicated union (built from the
    CSR arrays the substrate already carries). Triangle ids >= ``n_faces``
    (the appended voxel-wall triangles of non-periodic substrates) are
    excluded. Returns an (n_columns, K) -1-padded int array addressed by
    ``column = y * n_sv[2] + z``.
    """
    n_sv = np.asarray(substrate.n_sv).astype(int)
    ranges = np.asarray(substrate.subvoxel_indices)
    ids = np.asarray(substrate.triangle_indices)
    n_cols = int(n_sv[1] * n_sv[2])
    # CSR entries are subvoxel-major and contiguous: entry e belongs to the
    # subvoxel whose [start, end) slice contains it, and a subvoxel's
    # column is its index modulo n_cols (x is the leading axis).
    counts = ranges[:, 1] - ranges[:, 0]
    col_of_entry = (np.repeat(np.arange(len(counts)), counts) % n_cols)
    keep = ids < n_faces
    key = col_of_entry[keep] * np.int64(max(n_faces, 1)) + ids[keep]
    uniq = np.unique(key)
    cols_u = uniq // max(n_faces, 1)
    ids_u = uniq % max(n_faces, 1)
    per_col = np.bincount(cols_u, minlength=n_cols)
    K = max(1, int(per_col.max()) if per_col.size else 1)
    table = np.full((n_cols, K), -1, dtype=np.int64)
    offsets = np.concatenate(([0], np.cumsum(per_col)[:-1]))
    slot = np.arange(len(uniq)) - offsets[cols_u]
    table[cols_u, slot] = ids_u
    return table


def _make_intra_classifier(substrate, device, budget=None):
    """Build ``classify(points) -> bool (n,)``: True where the point lies
    inside the closed surface (odd +x-ray crossing parity), points in
    metres. For non-periodic substrates the 12 voxel-wall triangles
    appended at construction are excluded from the parity test.

    The triangles, the candidate columns and the crossing counts live on
    ``device`` (the simulation's; the CPU tests pass "cpu"), in float32;
    the host only plans the batches of at most ``budget`` (point, triangle)
    pairs (None: sized for the device's memory).
    """
    device = torch.device(device)
    vertices = substrate.vertices
    faces = substrate.faces
    if not substrate.periodic:
        vertices = vertices[:-8]
        faces = faces[:-12]
    triangles = torch.as_tensor(vertices[faces], dtype=torch.float32).to(
        device)
    columns = _column_candidates(substrate, len(faces))
    per_column = (columns >= 0).sum(axis=1)
    columns = torch.as_tensor(columns).to(device)
    n_sv = np.asarray(substrate.n_sv).astype(int)
    voxel_size = np.asarray(substrate.voxel_size)
    sv_width = voxel_size / n_sv
    if budget is None:
        # Eager torch materialises the (points, K, 3, 3) candidate gather
        # and ~10 temporaries of (points, K) floats: on a card, a quarter
        # of its free memory at 256 bytes a pair.
        budget = int(1e6)
        if device.type == "cuda":
            budget = max(budget, torch.cuda.mem_get_info(device)[0] // 1024)

    def classify(p):
        # Points go in batches of similar candidate counts, each batch
        # testing only up to its own largest count: column sizes vary
        # tenfold on a neuron mesh, and padding every point to the largest
        # column would test the padding. Each (point, triangle) test is
        # elementwise, so the parities do not depend on the batching.
        p = np.asarray(p, dtype=float)
        cy = np.clip((p[:, 1] / sv_width[1]).astype(int), 0, n_sv[1] - 1)
        cz = np.clip((p[:, 2] / sv_width[2]).astype(int), 0, n_sv[2] - 1)
        col = cy * n_sv[2] + cz
        order = np.argsort(per_column[col], kind="stable")
        k_sorted = per_column[col[order]]
        points = torch.as_tensor(p.astype(np.float32)).to(device)
        col_t = torch.as_tensor(col).to(device)
        order_t = torch.as_tensor(order).to(device)
        inside = torch.empty(len(p), dtype=torch.bool, device=device)
        s = 0
        while s < len(p):
            e = min(len(p), s + max(1, budget // max(k_sorted[s], 1)))
            while e - s > 1 and (e - s) * k_sorted[e - 1] > budget:
                e = s + max(1, budget // max(k_sorted[e - 1], 1))
            idx = order_t[s:e]
            k = max(int(k_sorted[e - 1]), 1)
            crossings = _count_crossings_x(points[idx], triangles,
                                           columns[col_t[idx], :k])
            inside[idx] = (crossings % 2).bool()
            s = e
        return inside.cpu().numpy()

    return classify


def _fill_mesh(n_points, substrate, intra, seed, device):
    """Sample points uniformly inside ("intra") or outside ("extra") the
    closed surface defined by a mesh substrate's triangles.

    Points are proposed uniformly over the voxel and classified by the
    parity of +x ray crossings (odd = inside).

    Parameters
    ----------
    n_points : int
    substrate : disimpy_tpu_torch.substrates._Substrate
    intra : bool
        True to sample inside the surface, False outside.
    seed : int
    device : str or torch.device
        Where the proposals are classified (``_make_intra_classifier``).

    Returns
    -------
    numpy.ndarray of shape (n_points, 3)
    """
    classify = _make_intra_classifier(substrate, device)
    rng = np.random.RandomState(seed)
    voxel_size = np.asarray(substrate.voxel_size)

    def proposal(k):
        return rng.random_sample((k, 3)) * voxel_size

    def accept(p):
        inside = classify(p)
        return inside if intra else ~inside

    return _rejection_fill(n_points, proposal, accept)


def add_noise_to_data(data, sigma, seed=None):
    """Add Rician noise: ``|data + N(0, sigma) + i N(0, sigma)|``.

    Parameters
    ----------
    data : numpy.ndarray
    sigma : float
        Noise standard deviation per channel.
    seed : int, optional

    Returns
    -------
    noisy_data : numpy.ndarray
    """
    if seed:
        np.random.seed(seed)
    data = np.asarray(data)
    return np.abs(
        data
        + np.random.normal(size=data.shape, scale=sigma, loc=0)
        + 1j * np.random.normal(size=data.shape, scale=sigma, loc=0)
    )


def _write_traj(traj, mode, positions):
    """Append one line with all walker positions to the trajectories file."""
    with open(traj, mode) as f:
        np.savetxt(f, np.asarray(positions, dtype=float).reshape(1, -1))


# ---------------------------------------------------------------------------
# Substrate preparation: host substrate -> engine spec + initial positions.
# ---------------------------------------------------------------------------


def _uniform_positions(n, voxel_scaled, seed, device, dtype=torch.float32):
    """(3, n) positions uniform in the voxel, drawn on ``device`` from a
    threefry stream keyed by the simulation seed."""
    ids = torch.arange(n, dtype=torch.int32, device=device)
    key = (seed & 0x7FFFFFFF) ^ UNIFORM_SALT
    w0, w1 = krng.step_words(key, 0, ids, 0)
    w2, _ = krng.step_words(key, 0, ids, 1)
    u = torch.stack([krng.uniform01(w, dtype) for w in (w0, w1, w2)])
    vox = torch.as_tensor(voxel_scaled, dtype=dtype, device=device)
    return u * vox[:, None]


def _mesh_positions(substrate, n_walkers, seed, scale, quiet, dtype, device):
    """(3, n) initial positions for a mesh substrate (step-length units)."""
    if isinstance(substrate.init_pos, np.ndarray):
        if n_walkers != substrate.init_pos.shape[0]:
            raise ValueError(
                "n_walkers must be equal to the number of initial positions"
            )
        pts = np.asarray(substrate.init_pos, dtype=float)
    elif substrate.init_pos == "uniform":
        return _uniform_positions(
            n_walkers, np.asarray(substrate.voxel_size) * scale, seed, device,
            dtype,
        )
    else:
        if not quiet:
            print("Calculating initial positions")
        pts = _fill_mesh(
            n_walkers, substrate, substrate.init_pos == "intra", seed, device
        )
        if not quiet:
            print("Finished calculating initial positions")
    return torch.as_tensor(pts.T * scale, dtype=dtype).to(device)


def _fused_spec(substrate, n_walkers, scale, device):
    """The substrate's fused spec (cached on it), or None when no fused
    configuration fits the geometry (e.g. a step length comparable to the
    voxel).

    The pack takes ``engine.config.fused_resort_every`` (the largest epoch
    length J) and ``fused_cell_steps`` (a fixed cell width, or None for the
    search), and both key the cache. A J outside 1..``fused.MAX_J`` raises
    ``pack_fused``'s ValueError.
    """
    from .engine import config as engine_config
    from .engine import fused

    J = engine_config.fused_resort_every
    cell_steps = engine_config.fused_cell_steps
    if not 1 <= J <= fused.MAX_J:
        raise ValueError(f"resort_every must be in [1, {fused.MAX_J}]")
    cache_key = (
        "fused-torch", float(scale), J, cell_steps,
        fused.quantize_n_hint(n_walkers), str(device),
    )
    if cache_key not in substrate._accel_cache:
        try:
            spec = fused.pack_fused(
                substrate, scale, resort_every=J, cell_steps=cell_steps,
                n_hint=float(n_walkers), device=device,
            )
        except ValueError:
            spec = None
        substrate._accel_cache[cache_key] = spec
    return substrate._accel_cache[cache_key]


def _classic_mesh_spec(substrate, scale, dtype, device):
    """The substrate's classic mesh spec (cached on it)."""
    from .engine import mesh_accel

    cache_key = ("classic-torch", float(scale), str(dtype), str(device))
    spec = substrate._accel_cache.get(cache_key)
    if spec is None:
        spec = mesh_accel.pack_mesh(substrate, scale, dtype, device=device)
        substrate._accel_cache[cache_key] = spec
    return spec


def _prepare_substrate(substrate, n_walkers, seed, scale, dtype, quiet,
                       mesh_engine, device):
    """Build the engine spec, the initial positions (3, n) on ``device``
    (substrate frame, step-length units), the frame->lab rotation (or
    None), a geometry-extent estimate and the mesh engine.

    ``mesh_engine`` asks for "fused" or "classic" on mesh substrates; a
    geometry the fused pack cannot serve goes to "classic".
    """

    def scalar(x):
        return torch.tensor(float(x), dtype=dtype, device=device)

    def host(p):
        return torch.as_tensor(p.T * scale, dtype=dtype).to(device)

    if substrate.type == "free":
        positions = torch.zeros((3, n_walkers), dtype=dtype, device=device)
        return FreeSpec(), positions, None, 1.0, "classic"

    if substrate.type == "sphere":
        r = substrate.radius
        spec = SphereSpec(radius=scalar(r * scale),
                          perm_prob=scalar(substrate.perm_prob))
        return (spec, host(_fill_sphere(n_walkers, r)), None, r * scale,
                "classic")

    if substrate.type == "cylinder":
        r = substrate.radius
        # A cylinder is symmetric under orientation sign flip; canonicalize
        # so that antiparallel orientations produce identical simulations.
        orientation = np.asarray(substrate.orientation, dtype=float)
        if orientation[np.argmax(np.abs(orientation))] < 0:
            orientation = -orientation
        # The engine runs in the cylinder frame (axis = +x).
        R = utils.vec2vec_rotmat(orientation, np.array([1.0, 0.0, 0.0]))
        frame_to_lab = np.linalg.inv(R)
        positions = np.zeros((n_walkers, 3))
        positions[:, 1:3] = _fill_circle(n_walkers, r)
        spec = CylinderSpec(radius=scalar(r * scale),
                            perm_prob=scalar(substrate.perm_prob))
        return spec, host(positions), frame_to_lab, r * scale, "classic"

    if substrate.type == "ellipsoid":
        semiaxes = np.asarray(substrate.semiaxes, dtype=float)
        frame_to_lab = np.asarray(substrate.R, dtype=float)
        spec = EllipsoidSpec(
            semiaxes=torch.as_tensor(semiaxes * scale, dtype=dtype).to(device),
            perm_prob=scalar(substrate.perm_prob),
        )
        return (
            spec, host(_fill_ellipsoid(n_walkers, semiaxes)), frame_to_lab,
            float(np.max(semiaxes)) * scale, "classic",
        )

    if substrate.type == "mesh":
        positions = _mesh_positions(
            substrate, n_walkers, seed, scale, quiet, dtype, device
        )
        spec = None
        if mesh_engine == "fused":
            spec = _fused_spec(substrate, n_walkers, scale, device)
        if spec is None:
            mesh_engine = "classic"
            spec = _classic_mesh_spec(substrate, scale, dtype, device)
        extent = float(np.max(substrate.voxel_size)) * scale
        return spec, positions, None, extent, mesh_engine

    raise ValueError("Incorrect value (%s) for substrate" % substrate)


def _effective_epsilon(epsilon, scale, extent, n_t, dtype, bounded):
    """Surface-offset magnitude in step-length units.

    The user value (metres, reference default 1e-13) is honored, but floored
    at ~64 ulps of the largest coordinate magnitude the simulation will
    visit, so the offset survives rounding: an offset below one ulp would
    leave walkers exactly on the surface and re-collide forever. The floor
    is a no-op in float64.

    For substrates whose coordinates stay within ``extent`` (sphere,
    ellipsoid, non-periodic mesh) the floor uses the extent only; the
    ``sqrt(n_t)`` diffusion-growth term applies only when coordinates are
    unbounded (cylinder axis, periodic mesh).
    """
    magnitude = max(float(extent), 1.0)
    if not bounded:
        magnitude = max(magnitude, math.sqrt(n_t) * 3.0)
    floor = 64.0 * float(torch.finfo(dtype).eps) * magnitude
    return max(float(epsilon) * scale, floor)


def _relaxation(relaxation, substrate):
    """Validate ``relaxation``: returns ``(pair, scalar)``, the
    (T2_intra, T2_extra) pair or None and the uniform T2 or None."""
    if relaxation is None:
        return None, None
    if isinstance(relaxation, (tuple, list)) and len(relaxation) == 2:
        t2_intra, t2_extra = float(relaxation[0]), float(relaxation[1])
        if t2_intra <= 0 or t2_extra <= 0:
            raise ValueError(
                "Incorrect value (%s) for relaxation" % (relaxation,))
        if substrate.type not in ("mesh", "sphere", "cylinder", "ellipsoid"):
            raise ValueError(
                "Two-compartment relaxation requires a substrate with a "
                "surface (mesh, sphere, cylinder, or ellipsoid)"
            )
        return (t2_intra, t2_extra), None
    if (isinstance(relaxation, (int, float)) and not isinstance(
            relaxation, bool) and relaxation > 0):
        return None, float(relaxation)
    raise ValueError("Incorrect value (%s) for relaxation" % (relaxation,))


def _start_parity(substrate, positions, step_l):
    """(n,) bool starting compartment of each spin (True = intra).

    Meshes seeded "intra" or "extra" start all in or all out; explicit and
    "uniform" positions are classified by ray-crossing parity on the
    positions' device (the mesh frame is the lab frame). Analytic
    compartments confine their spins (intra); free diffusion has no
    membrane (extra).
    """
    n = positions.shape[1]
    if substrate.type != "mesh":
        return np.full(n, substrate.type != "free", dtype=bool)
    init = substrate.init_pos
    if isinstance(init, str) and init in ("intra", "extra"):
        return np.full(n, init == "intra", dtype=bool)
    if isinstance(init, np.ndarray):
        points = np.asarray(init, dtype=float)
    else:
        points = positions.cpu().numpy().astype(float).T * step_l
    return _make_intra_classifier(substrate, positions.device)(points)


@dataclasses.dataclass
class _Part:
    """One device's contiguous share of the spins and its running state."""

    device: torch.device
    lo: int
    hi: int
    spec: object
    g_eff: torch.Tensor
    positions: torch.Tensor
    phases: torch.Tensor
    iter_exc: torch.Tensor
    compartments: tuple = None


def _engine_dtype(dtype):
    """Resolve ``dtype`` to torch.float32 or torch.float64."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    else:
        try:
            name = np.dtype(dtype).name
        except TypeError:
            raise ValueError("Incorrect value (%s) for dtype" % (dtype,))
    if name not in ("float32", "float64"):
        raise ValueError("Incorrect value (%s) for dtype" % (dtype,))
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# The driver.
# ---------------------------------------------------------------------------


def simulation(
    n_walkers,
    diffusivity,
    gradient,
    dt,
    substrate,
    seed=123,
    traj=None,
    final_pos=False,
    all_signals=False,
    quiet=False,
    cuda_bs=128,
    max_iter=int(1e3),
    epsilon=1e-13,
    dtype="float32",
    devices=None,
    relaxation=None,
    exchange_stats=False,
    device=None,
):
    """Simulate a diffusion-weighted MR experiment and return the signal.

    Parameters
    ----------
    n_walkers : int
        Number of random walkers (spins).
    diffusivity : float
        Diffusivity in SI units (m^2/s).
    gradient : numpy.ndarray
        Floating-point array of shape (number of measurements, number of
        time points, 3): gradient magnitude per time point per axis (T/m).
    dt : float
        Duration of a time step (s).
    substrate : disimpy_tpu_torch.substrates._Substrate
        Substrate object describing the microstructure.
    seed : int, optional
        Seed for random number generation. The same seed gives the same
        walks on any split over devices.
    traj : str, optional
        Path of a file in which to save walker trajectories (one line per
        time point: ``walker_1_x walker_1_y walker_1_z walker_2_x ...``).
        The file can become very large.
    final_pos : bool, optional
        If True, return ``(signals, final_positions)``.
    all_signals : bool, optional
        If True, return each walker's signal instead of the total.
    quiet : bool, optional
        If True, do not print progress.
    cuda_bs : int, optional
        Accepted for drop-in compatibility with the reference API; ignored.
    max_iter : int, optional
        Collision-iteration budget per time step; walkers that exhaust it
        are flagged, warned about, and excluded from the signal.
    epsilon : float, optional
        Distance (m) by which a walker is moved off a surface after a
        collision. Floored internally at the engine dtype's resolution.
    dtype : str, numpy dtype or torch dtype, optional
        Engine precision: "float32" (default) or "float64".
    devices : None, int, or sequence of devices, optional
        Split the spins over several devices: an int k takes the first k
        CUDA devices (raising if fewer exist), a sequence of devices or
        device strings takes exactly those (repeats allowed, e.g.
        ``["cuda:0", "cuda:0"]``). Each device runs a contiguous part of
        the spins in its own host thread; the signals are summed on the
        host. None (default) runs on ``device``.
    relaxation : float or (T2_intra, T2_extra) pair, optional
        T2 relaxation weighting. A single T2 (s) scales the signal by
        ``exp(-n_t * dt / T2)``. A pair (substrates with a surface: mesh,
        sphere, cylinder, ellipsoid) weights each spin by
        ``exp(-(dt / T2_intra) k - (dt / T2_extra) (n_t - k))``, where
        ``k`` is the number of steps it ended inside the surface, tracked
        through its membrane transits.
    exchange_stats : bool, optional
        If True, additionally return a dict of per-walker exchange
        statistics: ``crossings`` (membrane transits), ``intra_steps``
        (steps dwelt inside) and ``intra_fraction``, after the other
        return values.
    device : str or torch.device, optional
        Where the simulation runs ("cuda" by default). A CUDA device
        without a GPU raises; there is no CPU fallback. Beside
        ``devices`` it must name the same device as every entry.

    Returns
    -------
    signal : numpy.ndarray
        Simulated signal per measurement, ``Re sum_spins exp(i phi)``; or
        per-walker signals if ``all_signals``; with final walker positions
        as a tuple if ``final_pos``; with the exchange-statistics dict last
        if ``exchange_stats``.
    """
    # --- Validation (parity with the JAX package and the reference).
    if not isinstance(n_walkers, int) or n_walkers <= 0:
        raise ValueError("Incorrect value (%s) for n_walkers" % n_walkers)
    if not isinstance(diffusivity, float) or diffusivity <= 0:
        raise ValueError("Incorrect value (%s) for diffusivity" % diffusivity)
    if (
        not isinstance(gradient, np.ndarray)
        or gradient.ndim != 3
        or gradient.shape[2] != 3
        or not np.issubdtype(gradient.dtype, np.floating)
    ):
        raise ValueError("Incorrect value (%s) for gradient" % gradient)
    if not isinstance(dt, float) or dt <= 0:
        raise ValueError("Incorrect value (%s) for dt" % dt)
    if not isinstance(substrate, substrates._Substrate):
        raise ValueError("Incorrect value (%s) for substrate" % substrate)
    if not isinstance(seed, int) or seed < 0:
        raise ValueError("Incorrect value (%s) for seed" % seed)
    if traj:
        if not isinstance(traj, str):
            raise ValueError("Incorrect value (%s) for traj" % traj)
    if not isinstance(quiet, bool):
        raise ValueError("Incorrect value (%s) for quiet" % quiet)
    if not isinstance(cuda_bs, int) or cuda_bs <= 0:
        raise ValueError("Incorrect value (%s) for cuda_bs" % cuda_bs)
    if not isinstance(max_iter, int) or max_iter < 1:
        raise ValueError("Incorrect value (%s) for max_iter" % max_iter)
    if not isinstance(exchange_stats, bool):
        raise ValueError("Incorrect value (%s) for exchange_stats" % exchange_stats)
    relax_pair, relax_scalar = _relaxation(relaxation, substrate)
    # Per-spin compartment tracking rides the time loop; needed for
    # exchange statistics and for two-compartment relaxation.
    track = exchange_stats or relax_pair is not None
    dtype = _engine_dtype(dtype)
    devs = parallel.resolve_devices(devices, device)
    home = devs[0]
    engine_core.require_full_fp32()

    if not quiet:
        print("Starting simulation")
        if traj:
            print(
                "The trajectories file will be up to %s GB"
                % (gradient.shape[1] * n_walkers * 3 * 25 / 1e9)
            )
    n_meas, n_t, _ = gradient.shape
    step_l = np.sqrt(6 * diffusivity * dt)
    scale = 1.0 / step_l
    if not quiet:
        print("Number of random walkers = %s" % n_walkers)
        print("Number of steps = %s" % n_t)
        print("Step length = %s m" % step_l)
        print("Step duration = %s s" % dt)

    # Host RNG state as the JAX package sets it (analytic samplers).
    np.random.seed(seed)

    from .engine import config as engine_config

    mesh_engine = "classic"
    if substrate.type == "mesh":
        mesh_engine = engine_config.mesh_engine(dtype, needs_traj=bool(traj))
    spec, positions, frame_to_lab, extent, mesh_engine = _prepare_substrate(
        substrate, n_walkers, seed, scale, dtype, quiet, mesh_engine, home
    )
    kind = substrate.type

    # Phase coefficients: phi += GAMMA * dt * g . r with r in step-length
    # units -> g_eff[t, m, :] = GAMMA * dt * step_l * g[m, t, :], rotated
    # into the substrate frame when the engine runs in one.
    g_eff = (GAMMA * dt * step_l) * np.transpose(gradient, (1, 0, 2))
    if frame_to_lab is not None:
        # g . r_lab = g . (A r_frame) = (A^T g) . r_frame
        g_eff = g_eff @ frame_to_lab
    g_eff_dev = torch.as_tensor(g_eff, dtype=dtype).to(home)

    bounded = kind in ("sphere", "ellipsoid") or (
        kind == "mesh" and not substrate.periodic
    )
    eps_eff = _effective_epsilon(epsilon, scale, extent, n_t, dtype, bounded)

    # The fused table's dilation margin provisions for a bounded per-bounce
    # epsilon drift (engine/fused.py EPS_BOUNCES); a larger effective
    # epsilon (very long periodic runs, large user epsilon) goes to the
    # classic engine, whose per-bounce query has no drift budget.
    if mesh_engine == "fused" and eps_eff > spec.eps_budget:
        mesh_engine = "classic"
        spec = _classic_mesh_spec(substrate, scale, dtype, home)

    parity0 = (_start_parity(substrate, positions, step_l) if track
               else None)
    seed32 = seed & 0x7FFFFFFF

    # One part per device: contiguous spins, ids offset by the part's
    # first spin, so every spin walks as it does in a single run.
    parts = []
    ranges = parallel.split_ranges(n_walkers, len(devs))
    for dev, (lo, hi) in zip(devs, ranges):
        if hi == lo:
            continue
        m = hi - lo
        compartments = None
        if track:
            compartments = (
                torch.zeros(m, dtype=torch.int32, device=dev),
                torch.as_tensor(parity0[lo:hi]).to(dev),
                torch.zeros(m, dtype=torch.int32, device=dev),
            )
        parts.append(_Part(
            device=dev, lo=lo, hi=hi, spec=parallel.spec_to(spec, dev),
            g_eff=g_eff_dev.to(dev),
            positions=positions[:, lo:hi].to(dev).contiguous(),
            phases=torch.zeros((n_meas, m), dtype=dtype, device=dev),
            iter_exc=torch.zeros(m, dtype=torch.bool, device=dev),
            compartments=compartments,
        ))

    def to_lab(pos_scaled):
        """(3, n) engine positions -> (n, 3) lab-frame positions (metres)."""
        pos = pos_scaled.cpu().numpy().astype(float).T * step_l
        if frame_to_lab is not None:
            pos = pos @ frame_to_lab.T
        return pos

    if mesh_engine == "fused":
        from .engine import fused

        count = bool(engine_config.fused_count_units) and len(parts) == 1
        if count:
            _STREAM_DIAG[:] = [0, 0, 0]

        def fused_part(part):
            out = fused.run_window_fused(
                part.spec, part.positions, part.phases, part.iter_exc,
                part.g_eff, range(n_t), seed32, eps_eff, max_iter,
                id_base=part.lo, track=track,
                compartments=part.compartments, count=count,
            )
            part.positions, part.phases, part.iter_exc = out[:3]
            if track:
                part.compartments = out[3]
            if count:
                _STREAM_DIAG[:] = [int(c) for c in out[-1].tolist()]

        parallel.run_parts(fused_part, [(p,) for p in parts])
    else:
        if traj:
            _write_traj(traj, "w", to_lab(positions))
            # Windowed execution keeps the collected-trajectory buffer
            # bounded.
            window = max(1, min(n_t, int(3e7) // max(3 * n_walkers, 1)))
        else:
            window = n_t

        def classic_part(part, t0, t1):
            ids = part.lo + torch.arange(part.hi - part.lo, dtype=torch.int32,
                                         device=part.device)
            out = engine_core.run_window(
                kind, part.spec, part.positions, part.phases, part.iter_exc,
                part.g_eff[t0:t1], range(t0, t1), seed32, eps_eff, max_iter,
                collect_positions=bool(traj),
                track="exchange" if track else None,
                compartments=part.compartments, ids=ids,
            )
            part.positions, part.phases, part.iter_exc = out[0]
            if track:
                part.compartments = out[2]
            return out[1]

        for t0 in range(0, n_t, window):
            t1 = min(t0 + window, n_t)
            collected = parallel.run_parts(
                classic_part, [(p, t0, t1) for p in parts])
            if traj:
                steps = torch.cat([c.cpu() for c in collected], dim=2)
                for step_positions in steps:
                    _write_traj(traj, "a", to_lab(step_positions))
            if not quiet and n_t > window:
                print(f"\r{np.round(t1 / n_t * 100, 1)}%", end="", flush=True)

    # Signal reduction on each part's device; the exceeded-walker indices
    # are fetched only when a walker overflowed.
    if any(bool(p.iter_exc.any()) for p in parts):
        iter_exc = torch.cat([p.iter_exc.cpu() for p in parts]).numpy()
        warnings.warn(
            "Maximum number of iterations was exceeded in the intersection "
            + "check algorithm for walkers %s" % np.where(iter_exc)[0]
        )

    def signal_of(part):
        # Relaxation weighting: per-spin weights from the dwell steps.
        weights = None
        if relax_pair is not None:
            k_intra = part.compartments[2].to(dtype)
            lw = (dt / relax_pair[0]) * k_intra + (dt / relax_pair[1]) * (
                float(n_t) - k_intra
            )
            weights = torch.exp(-lw)
        if all_signals:
            out = engine_core.per_spin_signal(part.phases, part.iter_exc,
                                              weights=weights)
        else:
            out = engine_core.reduce_signal(part.phases, part.iter_exc,
                                            weights=weights)
        return out.cpu().numpy().astype(float)

    per_part = [signal_of(p) for p in parts]
    if all_signals:
        signals = np.concatenate(per_part, axis=1)
    else:
        signals = per_part[0]
        for other in per_part[1:]:
            signals = signals + other
    if relax_scalar is not None:
        signals = signals * np.exp(-n_t * dt / relax_scalar)
    if not quiet:
        print("\rSimulation finished")
    ret = [signals]
    if final_pos:
        ret.append(np.concatenate([to_lab(p.positions) for p in parts]))
    if exchange_stats:
        crossings, _, intra_steps = (
            np.concatenate([p.compartments[k].cpu().numpy() for p in parts])
            for k in range(3)
        )
        ret.append({
            "crossings": crossings,
            "intra_steps": intra_steps,
            "intra_fraction": intra_steps / float(n_t),
        })
    return tuple(ret) if len(ret) > 1 else signals
