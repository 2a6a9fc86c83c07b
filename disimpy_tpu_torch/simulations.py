"""Diffusion-weighted MR simulation driver (PyTorch).

``simulation(...)`` takes the JAX package's signature plus ``device``.
This package so far runs:

- free diffusion (``substrates.free()``);
- triangle-mesh substrates in float32 without trajectory output, through
  the fused epoch engine (``engine/fused.py`` and the CUDA kernel
  ``csrc/fused_epoch.cu``), impermeable or permeable, seeded "uniform"
  (on the device), "intra"/"extra" (host ray-parity sampling) or from an
  explicit array.

Everything else — the analytic substrates, the classic per-bounce mesh
engine (float64, trajectories, runs the fused table cannot serve), several
devices, relaxation and exchange statistics — raises
``NotImplementedError`` naming the later part of the port that brings it.

All geometry is rescaled to step-length units. Randomness is the
counter-based threefry of ``engine/krng.py``, keyed per (seed, step, spin
id); host-side seeding uses the same numpy RNG calls as the JAX package, so
"intra"/"extra" seeds equal its seeds bit for bit.
"""

import math
import warnings

import numpy as np
import torch

from . import substrates
from .engine import core as engine_core
from .engine import krng
from .gradients import GAMMA

__all__ = ["simulation", "add_noise_to_data"]

# Mixed into the simulation seed for device-side "uniform" mesh seeding.
UNIFORM_SALT = 0x756E6966

_CLASSIC = (
    "the classic per-bounce mesh engine (analytic substrates, float64, "
    "trajectories and meshes the fused table cannot serve) is not ported "
    "yet: it comes with slice 2 of the port"
)


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


def _ray_crossings_x(points, triangles, tri_subset=None):
    """Number of triangles crossed by the +x ray from each point.

    ``points`` is (n, 3); ``triangles`` is (m, 3, 3). If ``tri_subset`` is
    given — an (n, K) int array of candidate triangle indices per point,
    -1-padded — only those triangles are tested. Runs in float32 on CPU
    tensors: seeding is host-side preprocessing.
    """
    points = np.asarray(points, dtype=np.float32)
    if tri_subset is None:
        tri_subset = np.broadcast_to(
            np.arange(len(triangles))[None, :], (len(points), len(triangles))
        )
    counts = _count_crossings_x(
        torch.from_numpy(points),
        torch.as_tensor(np.asarray(triangles), dtype=torch.float32),
        torch.as_tensor(np.asarray(tri_subset), dtype=torch.int64),
    )
    return counts.numpy()


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


def _make_intra_classifier(substrate):
    """Build ``classify(points) -> bool (n,)``: True where the point lies
    inside the closed surface (odd +x-ray crossing parity), points in
    metres. For non-periodic substrates the 12 voxel-wall triangles
    appended at construction are excluded from the parity test.
    """
    vertices = substrate.vertices
    faces = substrate.faces
    if not substrate.periodic:
        vertices = vertices[:-8]
        faces = faces[:-12]
    triangles = vertices[faces]
    columns = _column_candidates(substrate, len(faces))
    n_sv = np.asarray(substrate.n_sv).astype(int)
    voxel_size = np.asarray(substrate.voxel_size)
    sv_width = voxel_size / n_sv
    # Points per chunk: eager torch materialises the (chunk, K, 3, 3)
    # candidate gather, so keep it to ~1e6 (point, triangle) pairs.
    chunk = max(64, int(1e6) // max(columns.shape[1], 1))

    def classify(p):
        p = np.asarray(p, dtype=float)
        inside = np.empty(len(p), dtype=bool)
        for s in range(0, len(p), chunk):
            q = p[s : s + chunk]
            cy = np.clip((q[:, 1] / sv_width[1]).astype(int), 0, n_sv[1] - 1)
            cz = np.clip((q[:, 2] / sv_width[2]).astype(int), 0, n_sv[2] - 1)
            candidates = columns[cy * n_sv[2] + cz]
            inside[s : s + chunk] = (
                _ray_crossings_x(q, triangles, candidates) % 2
            ).astype(bool)
        return inside

    return classify


def _fill_mesh(n_points, substrate, intra, seed):
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

    Returns
    -------
    numpy.ndarray of shape (n_points, 3)
    """
    classify = _make_intra_classifier(substrate)
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


# ---------------------------------------------------------------------------
# Substrate preparation: host substrate -> engine spec + initial positions.
# ---------------------------------------------------------------------------


def _uniform_positions(n, voxel_scaled, seed, device):
    """(3, n) float32 positions uniform in the voxel, drawn on ``device``
    from a threefry stream keyed by the simulation seed."""
    ids = torch.arange(n, dtype=torch.int32, device=device)
    key = (seed & 0x7FFFFFFF) ^ UNIFORM_SALT
    w0, w1 = krng.step_words(key, 0, ids, 0)
    w2, _ = krng.step_words(key, 0, ids, 1)
    u = torch.stack([krng.uniform01(w) for w in (w0, w1, w2)])
    vox = torch.as_tensor(voxel_scaled, dtype=torch.float32, device=device)
    return u * vox[:, None]


def _prepare_mesh(substrate, n_walkers, seed, scale, quiet, device):
    """Fused spec and initial positions (3, n) for a mesh substrate."""
    from .engine import fused

    if isinstance(substrate.init_pos, np.ndarray):
        if n_walkers != substrate.init_pos.shape[0]:
            raise ValueError(
                "n_walkers must be equal to the number of initial positions"
            )
        positions = torch.as_tensor(
            np.asarray(substrate.init_pos, dtype=float).T * scale,
            dtype=torch.float32,
        ).to(device)
    elif substrate.init_pos == "uniform":
        positions = _uniform_positions(
            n_walkers, np.asarray(substrate.voxel_size) * scale, seed, device
        )
    else:
        if not quiet:
            print("Calculating initial positions")
        pts = _fill_mesh(
            n_walkers, substrate, substrate.init_pos == "intra", seed
        )
        if not quiet:
            print("Finished calculating initial positions")
        positions = torch.as_tensor(
            pts.T * scale, dtype=torch.float32
        ).to(device)

    cache_key = (
        "fused-torch", float(scale), fused.quantize_n_hint(n_walkers),
        str(device),
    )
    spec = substrate._accel_cache.get(cache_key)
    if spec is None:
        try:
            spec = fused.pack_fused(
                substrate, scale, n_hint=float(n_walkers), device=device
            )
        except ValueError as e:
            # Geometry too dense for any fused configuration (e.g. step
            # length comparable to the voxel).
            raise NotImplementedError(f"{e}; {_CLASSIC}") from e
        substrate._accel_cache[cache_key] = spec
    return spec, positions


def _effective_epsilon(epsilon, scale, extent, n_t, dtype, bounded):
    """Surface-offset magnitude in step-length units.

    The user value (metres, reference default 1e-13) is honored, but floored
    at ~64 ulps of the largest coordinate magnitude the simulation will
    visit, so the offset survives rounding in float32: an offset below one
    ulp would leave walkers exactly on the surface and re-collide forever.

    For substrates whose coordinates stay within ``extent`` (non-periodic
    mesh) the floor uses the extent only; the ``sqrt(n_t)`` diffusion-growth
    term applies only when coordinates are unbounded (periodic mesh).
    """
    magnitude = max(float(extent), 1.0)
    if not bounded:
        magnitude = max(magnitude, math.sqrt(n_t) * 3.0)
    floor = 64.0 * float(torch.finfo(dtype).eps) * magnitude
    return max(float(epsilon) * scale, floor)


def _engine_dtype(dtype):
    """Resolve ``dtype``: float32 runs, float64 is not ported yet."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    else:
        try:
            name = np.dtype(dtype).name
        except TypeError:
            raise ValueError("Incorrect value (%s) for dtype" % (dtype,))
    if name == "float64":
        raise NotImplementedError(f"dtype='float64': {_CLASSIC}")
    if name != "float32":
        raise ValueError("Incorrect value (%s) for dtype" % (dtype,))
    return torch.float32


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
    device="cuda",
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
        Substrate object describing the microstructure: ``free()`` or a
        mesh.
    seed : int, optional
        Seed for random number generation.
    traj : str, optional
        Trajectory output; not ported yet (raises NotImplementedError).
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
        collision. Floored internally at float32 resolution.
    dtype : str, optional
        Engine precision: "float32" ("float64" is not ported yet).
    devices, relaxation, exchange_stats : optional
        Not ported yet: anything but the defaults raises
        NotImplementedError.
    device : str or torch.device, optional
        Where the simulation runs ("cuda" by default). A CUDA device
        without a GPU raises; there is no CPU fallback.

    Returns
    -------
    signal : numpy.ndarray
        Simulated signal per measurement, ``Re sum_spins exp(i phi)``; or
        per-walker signals if ``all_signals``; with final walker positions
        as a tuple if ``final_pos``.
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
    dtype = _engine_dtype(dtype)

    # --- What this part of the port does not run yet.
    later = "slice 3 of the port"
    if devices is not None:
        raise NotImplementedError(f"devices= (several GPUs) comes with {later}")
    if relaxation is not None or exchange_stats:
        raise NotImplementedError(
            f"relaxation and exchange_stats come with {later}"
        )
    if substrate.type not in ("free", "mesh"):
        raise NotImplementedError(f"{substrate.type} substrate: {_CLASSIC}")
    if traj:
        raise NotImplementedError(f"traj output: {_CLASSIC}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch finds no CUDA GPU; pass device='cpu' "
            "to run the plain-torch engine on the CPU"
        )
    engine_core.require_full_fp32()

    if not quiet:
        print("Starting simulation")
    n_meas, n_t, _ = gradient.shape
    step_l = np.sqrt(6 * diffusivity * dt)
    scale = 1.0 / step_l
    if not quiet:
        print("Number of random walkers = %s" % n_walkers)
        print("Number of steps = %s" % n_t)
        print("Step length = %s m" % step_l)
        print("Step duration = %s s" % dt)

    # Host RNG state as the JAX package sets it.
    np.random.seed(seed)

    # Phase coefficients: phi += GAMMA * dt * g . r with r in step-length
    # units -> g_eff[t, m, :] = GAMMA * dt * step_l * g[m, t, :].
    g_eff = (GAMMA * dt * step_l) * np.transpose(gradient, (1, 0, 2))
    g_eff_dev = torch.as_tensor(g_eff, dtype=dtype).to(device)
    phases = torch.zeros((n_meas, n_walkers), dtype=dtype, device=device)
    iter_exc = torch.zeros(n_walkers, dtype=torch.bool, device=device)
    seed32 = seed & 0x7FFFFFFF

    if substrate.type == "free":
        positions = torch.zeros((3, n_walkers), dtype=dtype, device=device)
        positions, phases = engine_core.run_window_free(
            positions, phases, g_eff_dev, range(n_t), seed32
        )
    else:
        from .engine import config as engine_config
        from .engine import fused

        if engine_config.mesh_engine(dtype, needs_traj=False) != "fused":
            raise NotImplementedError(_CLASSIC)
        spec, positions = _prepare_mesh(
            substrate, n_walkers, seed, scale, quiet, device
        )
        extent = float(np.max(substrate.voxel_size)) * scale
        eps_eff = _effective_epsilon(
            epsilon, scale, extent, n_t, dtype, not substrate.periodic
        )
        # The fused table's dilation margin provisions for a bounded
        # per-bounce epsilon drift (engine/fused.py EPS_BOUNCES).
        if eps_eff > spec.eps_budget:
            raise NotImplementedError(
                f"effective epsilon {eps_eff:.3g} exceeds the fused table's "
                f"budget {spec.eps_budget:.3g}; {_CLASSIC}"
            )
        positions, phases, iter_exc = fused.run_window_fused(
            spec, positions, phases, iter_exc, g_eff_dev, range(n_t),
            seed32, eps_eff, max_iter,
        )

    # Signal reduction on the device; the exceeded-walker indices are
    # fetched only when a walker overflowed.
    if bool(iter_exc.any()):
        warnings.warn(
            "Maximum number of iterations was exceeded in the intersection "
            + "check algorithm for walkers %s"
            % np.where(iter_exc.cpu().numpy())[0]
        )
    if all_signals:
        signals = engine_core.per_spin_signal(phases, iter_exc)
    else:
        signals = engine_core.reduce_signal(phases, iter_exc)
    signals = signals.cpu().numpy().astype(float)
    if not quiet:
        print("\rSimulation finished")
    if final_pos:
        pos = positions.cpu().numpy().astype(float).T * step_l
        return signals, pos
    return signals
