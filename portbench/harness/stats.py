"""The arithmetic of the end-to-end metrics and of the correctness check."""

import numpy as np

# A spin's final position departs from the reference's when it lies more
# than this many step lengths from it: float32 rounding moves a position
# by ~1e-5 step lengths over a call, a different collision by far more.
POSITION_TOL = 0.01
# The numbers a cell's limits hold each compared call to.
COMPARED = ("signal_gap", "position_share")


def rate(work_units, window_s):
    """Work completed per second over the whole window."""
    return float(np.sum(work_units)) / window_s


def percentile(values, q):
    """The q-th percentile (0-100) of ``values``, linear between order
    statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values, dtype=float), q))


def signal_gap(program, reference, n_walkers):
    """The widest gap between two signals, per spin: max over measurements
    of |program - reference| / n_walkers."""
    program = np.asarray(program, dtype=float)
    reference = np.asarray(reference, dtype=float)
    if program.shape != reference.shape or not np.all(np.isfinite(program)):
        return float("inf")
    return float(np.max(np.abs(program - reference)) / n_walkers)


def position_share(program, reference, voxel, step, tol):
    """The share of spins whose final position lies more than ``tol`` step
    lengths from the reference's, each difference taken to its nearest
    periodic image of the voxel (along an axis whose side is infinite, a
    geometry that does not repeat, the plain difference); 1 where the
    shapes differ or a position is not finite."""
    program = np.asarray(program, dtype=float)
    reference = np.asarray(reference, dtype=float)
    if program.shape != reference.shape or not np.all(np.isfinite(program)):
        return 1.0
    voxel = np.asarray(voxel, dtype=float)
    d = program - reference
    wrap = np.isfinite(voxel)
    d[:, wrap] -= np.round(d[:, wrap] / voxel[wrap]) * voxel[wrap]
    far = np.linalg.norm(d, axis=1) > tol * step
    return float(np.mean(far))


def compared(signal, positions, reference, n_walkers):
    """Each number of ``COMPARED`` for one call of the program (its signal
    and final positions, None if it returned none) against the reference's
    walk of the same call (``reference.walk.Walk``)."""
    share = 1.0 if positions is None else position_share(
        positions, reference.positions, reference.voxel, reference.step,
        POSITION_TOL)
    return {"signal_gap": signal_gap(signal, reference.signal, n_walkers),
            "position_share": share}
