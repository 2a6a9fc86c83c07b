"""Batched microstructure sweeps: many substrate variants in one ensemble.

The reference runs one substrate per ``simulation()`` call. Here the
variants of a sweep (a set of cylinder or sphere radii) advance side by
side as one ensemble of R * n spins: the spec holds a radius per spin, each
spin gets its variant's effective surface offset, and the spin ids repeat
``arange(n)`` per variant. Each variant's phases accrue through the same
matrix product a standalone run does, and its signal is reduced on its own.

Waveform sweeps need no machinery: the measurement axis already batches
arbitrary waveforms — concatenate them along axis 0 of ``gradient``.

RNG note: every variant uses the same id-keyed streams as a single
:func:`disimpy_tpu_torch.simulations.simulation` run with the same seed, so
row ``i`` of a sweep is the corresponding standalone simulation, and the
rows are correlated with each other (common random numbers: ideal for
comparing variants; draw different seeds for independent ensembles).
"""

import numpy as np
import torch

from . import parallel, utils
from .engine import core as engine_core
from .engine.specs import CylinderSpec, SphereSpec
from .gradients import GAMMA
from .simulations import (_effective_epsilon, _engine_dtype, _fill_circle,
                          _fill_sphere)

__all__ = ["sweep_cylinder_radii", "sweep_sphere_radii"]


def _common(gradient, dt, diffusivity):
    n_meas, n_t, _ = gradient.shape
    step_l = float(np.sqrt(6 * diffusivity * dt))
    g_eff = (GAMMA * dt * step_l) * np.transpose(gradient, (1, 0, 2))
    return n_meas, n_t, step_l, g_eff


def sweep_cylinder_radii(
    n_walkers,
    diffusivity,
    gradient,
    dt,
    radii,
    orientation=np.array([1.0, 0.0, 0.0]),
    seed=123,
    max_iter=int(1e3),
    epsilon=1e-13,
    dtype="float32",
    device="cuda",
):
    """Simulate one experiment inside cylinders of several radii at once.

    Parameters mirror :func:`disimpy_tpu_torch.simulations.simulation`;
    ``radii`` is a sequence of R cylinder radii (metres). Returns an
    (R, n_measurements) signal array; row i equals the standalone
    simulation of radius ``radii[i]`` with the same seed.
    """
    radii = np.asarray(radii, dtype=float)
    dtype = _engine_dtype(dtype)
    device = parallel.resolve_devices(None, device)[0]
    n_meas, n_t, step_l, g_eff = _common(gradient, dt, diffusivity)
    scale = 1.0 / step_l

    orientation = np.asarray(orientation, dtype=float)
    if orientation[np.argmax(np.abs(orientation))] < 0:
        orientation = -orientation
    R = utils.vec2vec_rotmat(orientation, np.array([1.0, 0.0, 0.0]))
    frame_to_lab = np.linalg.inv(R)
    g_eff = g_eff @ frame_to_lab

    positions = np.zeros((len(radii), 3, n_walkers))
    for i, r in enumerate(radii):
        np.random.seed(seed)
        positions[i, 1:3] = _fill_circle(n_walkers, r).T * scale
    return _finish(
        "cylinder", CylinderSpec, positions, radii * scale, g_eff, n_meas,
        n_t, scale, seed, max_iter, epsilon, dtype, device, bounded=False,
    )


def sweep_sphere_radii(
    n_walkers,
    diffusivity,
    gradient,
    dt,
    radii,
    seed=123,
    max_iter=int(1e3),
    epsilon=1e-13,
    dtype="float32",
    device="cuda",
):
    """Simulate one experiment inside spheres of several radii at once.

    Returns an (R, n_measurements) signal array; see
    :func:`sweep_cylinder_radii`.
    """
    radii = np.asarray(radii, dtype=float)
    dtype = _engine_dtype(dtype)
    device = parallel.resolve_devices(None, device)[0]
    n_meas, n_t, step_l, g_eff = _common(gradient, dt, diffusivity)
    scale = 1.0 / step_l
    positions = np.zeros((len(radii), 3, n_walkers))
    for i, r in enumerate(radii):
        np.random.seed(seed)
        positions[i] = _fill_sphere(n_walkers, r).T * scale
    return _finish(
        "sphere", SphereSpec, positions, radii * scale, g_eff, n_meas, n_t,
        scale, seed, max_iter, epsilon, dtype, device, bounded=True,
    )


def _finish(kind, spec_cls, positions, radii_scaled, g_eff, n_meas, n_t,
            scale, seed, max_iter, epsilon, dtype, device, bounded):
    n_batch, _, n = positions.shape

    def per_spin(values):
        return torch.as_tensor(np.repeat(values, n), dtype=dtype).to(device)

    # Per-variant epsilon: each row reproduces its standalone simulation
    # (the effective epsilon depends on the geometry extent).
    eps_eff = np.array([
        _effective_epsilon(epsilon, scale, float(e), n_t, dtype, bounded)
        for e in radii_scaled
    ])
    spec = spec_cls(radius=per_spin(radii_scaled),
                    perm_prob=torch.tensor(0.0, dtype=dtype, device=device))
    ids = torch.arange(n, dtype=torch.int32, device=device).repeat(n_batch)
    pos = torch.as_tensor(
        np.ascontiguousarray(positions.transpose(1, 0, 2)).reshape(3, -1),
        dtype=dtype).to(device)
    (_, phases, iter_exc), _ = engine_core.run_window(
        kind, spec, pos,
        torch.zeros((n_meas, n_batch * n), dtype=dtype, device=device),
        torch.zeros(n_batch * n, dtype=torch.bool, device=device),
        torch.as_tensor(g_eff, dtype=dtype).to(device), range(n_t),
        seed & 0x7FFFFFFF, per_spin(eps_eff), max_iter, ids=ids,
        blocks=n_batch,
    )
    signals = [
        engine_core.reduce_signal(phases[:, b * n:(b + 1) * n].contiguous(),
                                  iter_exc[b * n:(b + 1) * n])
        for b in range(n_batch)
    ]
    return torch.stack(signals).cpu().numpy().astype(float)
