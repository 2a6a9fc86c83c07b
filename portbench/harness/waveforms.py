"""Gradient waveforms made by the benchmark (plain NumPy).

A traffic file's ``waveform`` names a published PGSE protocol by the grid
it is written on: ``points`` samples, ones at ``[1:lobe]`` and minus ones
at ``[-lobe:-1]`` along ``axis``, the way the reference project's MISST
tests write it (``tests/test_simulations.py:526-570``: 700 points over 70
ms with 300-point lobes, small delta 30 ms, big delta 40 ms). It is
resampled linearly to the traffic's ``n_t`` points over the same duration
(a frozen copy of ``gradients.interpolate_gradient``) and scaled to each
b-value (``gradients.set_b``). Both the program and the reference get the
array this makes.
"""

import numpy as np

GAMMA = 267.513e6


def _b_values(gradient, dt):
    mean = 0.5 * (gradient[:, 1:, :] + gradient[:, :-1, :])
    q = GAMMA * np.concatenate((np.zeros((gradient.shape[0], 1, 3)),
                                np.cumsum(dt * mean, axis=1)), axis=1)
    q2 = np.linalg.norm(q, axis=2) ** 2
    return dt * (q2[:, 1:] + q2[:, :-1]).sum(axis=1) / 2.0


def _resample(gradient, n_t):
    """Linear resampling onto ``n_t`` points over the same duration."""
    n_old = gradient.shape[1]
    frac = np.linspace(0.0, n_old - 1.0, n_t)
    i0 = np.clip(np.floor(frac).astype(int), 0, n_old - 2)
    w = (frac - i0)[None, :, None]
    return (1.0 - w) * gradient[:, i0, :] + w * gradient[:, i0 + 1, :]


def lobes(points, lobe, axis, n_t, dt, bvals):
    """(gradient (n_meas, n_t, 3) in T/m) of a two-lobe PGSE written on a
    ``points``-sample grid, for time step ``dt`` after resampling."""
    if not (1 < lobe and 2 * lobe <= points):
        raise ValueError(f"lobes of {lobe} points overlap on {points}")
    grid = np.zeros((1, points, 3))
    grid[0, 1:lobe, axis] = 1.0
    grid[0, -lobe:-1, axis] = -1.0
    g = np.repeat(_resample(grid, n_t), len(bvals), axis=0)
    return g * np.sqrt(np.asarray(bvals) / _b_values(g, dt))[:, None, None]


def make(traffic):
    """The gradient array a traffic file asks for."""
    w = traffic["waveform"]
    if w["kind"] != "lobes":
        raise ValueError(f"unknown waveform {w['kind']!r}")
    b = w["bvals"]
    bvals = np.linspace(b["start"], b["stop"], b["num"])
    return lobes(w["points"], w["lobe"], w["axis"], traffic["n_t"],
                 traffic["dt"], bvals)
