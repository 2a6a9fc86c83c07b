"""Gradient-waveform toolkit.

A *gradient array* is a ``numpy.ndarray`` of shape
``(n_measurements, n_time_points, 3)`` holding the gradient vector in SI
units (T/m) at every time point of every measurement.  All functions here are
pure NumPy host-side preprocessing: waveforms are tiny compared to the spin
ensemble, and keeping them in float64 NumPy preserves exact b-value math.
The simulation engine consumes the waveform as a per-step phase-coefficient
array (see :mod:`disimpy_tpu_torch.engine`).

API parity: mirrors the reference toolkit ``disimpy/gradients.py``
(interpolate_gradient, calc_q, calc_b, set_b, rotate_gradient, pgse,
load_camino_scheme_file; reference lines 16-214), with the addition of
:func:`save_camino_scheme_file`.
"""

import numpy as np

from . import utils

#: Gyromagnetic ratio of the simulated spins (rad/s/T).
#: Reference: disimpy/gradients.py:13.
GAMMA = 267.513e6

# np.trapz was deprecated in favour of np.trapezoid in NumPy 2.0.
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def interpolate_gradient(gradient, dt, n_t):
    """Linearly resample a gradient array to ``n_t`` time points.

    The waveform duration ``T = dt * (n_old - 1)`` is preserved; the returned
    time step is ``T / (n_t - 1)``.

    Parameters
    ----------
    gradient : numpy.ndarray
        Gradient array of shape (n of measurements, n of time points, 3).
    dt : float
        Time-step duration of the input gradient array (s).
    n_t : int
        Number of time points after resampling.

    Returns
    -------
    interp_g : numpy.ndarray
        Resampled gradient array of shape (n of measurements, n_t, 3).
    dt : float
        Time-step duration of the resampled array (s).

    Notes
    -----
    Behavior parity with reference ``gradients.interpolate_gradient``
    (disimpy/gradients.py:16-45), vectorized over measurements and axes
    instead of looping ``np.interp``.
    """
    gradient = np.asarray(gradient, dtype=float)
    n_old = gradient.shape[1]
    T = dt * (n_old - 1)
    new_dt = T / (n_t - 1)
    # Both time grids are uniform over [0, T]; linear interpolation reduces
    # to a fractional-index lookup, vectorized over all measurements/axes.
    frac_idx = np.linspace(0.0, n_old - 1.0, n_t)
    i0 = np.clip(np.floor(frac_idx).astype(int), 0, n_old - 2)
    w = (frac_idx - i0)[np.newaxis, :, np.newaxis]
    interp_g = (1.0 - w) * gradient[:, i0, :] + w * gradient[:, i0 + 1, :]
    return interp_g, new_dt


def calc_q(gradient, dt):
    """Compute the q-vector array ``q(t) = GAMMA * cumulative-trapezoid(g)``.

    Parameters
    ----------
    gradient : numpy.ndarray
        Gradient array of shape (n of measurements, n of time points, 3).
    dt : float
        Time-step duration (s).

    Returns
    -------
    q : numpy.ndarray
        q-vector array with the same shape as ``gradient`` (1/m, up to 2*pi).

    Notes
    -----
    Parity with reference ``gradients.calc_q`` (disimpy/gradients.py:48-70):
    trapezoidal cumulative integration with a leading zero sample.
    """
    gradient = np.asarray(gradient, dtype=float)
    segment_means = 0.5 * (gradient[:, 1:, :] + gradient[:, :-1, :])
    cum = np.cumsum(dt * segment_means, axis=1)
    zero = np.zeros((gradient.shape[0], 1, 3))
    return GAMMA * np.concatenate((zero, cum), axis=1)


def calc_b(gradient, dt):
    """Compute the b-value of each measurement: ``b = integral |q(t)|^2 dt``.

    Parameters
    ----------
    gradient : numpy.ndarray
        Gradient array of shape (n of measurements, n of time points, 3).
    dt : float
        Time-step duration (s).

    Returns
    -------
    b : numpy.ndarray
        b-values of shape (n of measurements,) in SI units (s/m^2).

    Notes
    -----
    Parity with reference ``gradients.calc_b`` (disimpy/gradients.py:73-90).
    """
    q = calc_q(gradient, dt)
    return _trapezoid(np.linalg.norm(q, axis=2) ** 2, axis=1, dx=dt)


def set_b(gradient, dt, b):
    """Scale waveform magnitudes so each measurement has the target b-value.

    Parameters
    ----------
    gradient : numpy.ndarray
        Gradient array of shape (n of measurements, n of time points, 3).
    dt : float
        Time-step duration (s).
    b : float or numpy.ndarray
        Target b-value, or an array with one target per measurement.

    Returns
    -------
    scaled_g : numpy.ndarray
        Scaled gradient array.

    Raises
    ------
    Exception
        If any measurement of the input has b = 0 (its magnitude cannot be
        scaled to a nonzero b-value).

    Notes
    -----
    Parity with reference ``gradients.set_b`` (disimpy/gradients.py:93-115),
    including the exception type and b = 0 check on the *input* waveform.
    """
    b = np.asarray(b, dtype=float)
    current_b = calc_b(gradient, dt)
    if np.any(np.isclose(current_b, 0)):
        raise Exception("b-value can not be changed for measurements with b = 0")
    scale = np.sqrt(b / current_b)
    return gradient * scale[:, np.newaxis, np.newaxis]


def rotate_gradient(gradient, Rs):
    """Rotate each measurement's waveform by its own rotation matrix.

    Parameters
    ----------
    gradient : numpy.ndarray
        Gradient array of shape (n of measurements, n of time points, 3).
    Rs : numpy.ndarray
        Rotation matrices of shape (n of measurements, 3, 3).

    Returns
    -------
    g : numpy.ndarray
        Rotated gradient array.

    Raises
    ------
    ValueError
        If any matrix is not a proper rotation (det = 1 and R^T = R^-1).

    Notes
    -----
    Parity with reference ``gradients.rotate_gradient``
    (disimpy/gradients.py:118-141). The rotation is applied as
    ``g'(t) = R g(t)`` for every time point.
    """
    Rs = np.asarray(Rs, dtype=float)
    for i, R in enumerate(Rs):
        if not np.isclose(np.linalg.det(R), 1) or not np.all(
            np.isclose(R.T, np.linalg.inv(R))
        ):
            raise ValueError(f"Rs[{i}] ({R}) is not a valid rotation matrix")
    # g'[m, t, :] = Rs[m] @ g[m, t, :]
    return np.einsum("mij,mtj->mti", Rs, np.asarray(gradient, dtype=float))


def pgse(delta, DELTA, n_t, bvals, bvecs):
    """Synthesize a pulsed-gradient spin-echo (Stejskal-Tanner) waveform set.

    Two rectangular lobes of duration ``delta`` separated so the total
    waveform spans ``delta + DELTA``; one measurement per (b-value, b-vector)
    pair, scaled to the exact b-values and rotated from +x onto each b-vector.

    Parameters
    ----------
    delta : float
        Diffusion-encoding (lobe) duration (s).
    DELTA : float
        Diffusion time, i.e. lobe-onset separation (s).
    n_t : int
        Number of time points in the returned gradient array.
    bvals : float or numpy.ndarray
        b-value(s) in SI units (s/m^2).
    bvecs : numpy.ndarray
        Unit b-vector(s), shape (n of measurements, 3) (or (3,) for one).

    Returns
    -------
    gradient : numpy.ndarray
        Gradient array of shape (n of measurements, n_t, 3).
    dt : float
        Time-step duration (s).

    Notes
    -----
    Parity with reference ``gradients.pgse`` (disimpy/gradients.py:144-179):
    the ideal waveform is rendered on a 1e6-point grid (so lobe edges land
    within T/1e6 of the requested times), resampled to ``n_t``, replicated
    per b-value, magnitude-scaled with :func:`set_b`, and rotated with
    :func:`rotate_gradient`.
    """
    bvals = np.atleast_1d(np.asarray(bvals, dtype=float))
    bvecs = np.atleast_2d(np.asarray(bvecs, dtype=float))
    n_fine = int(1e6)
    waveform = np.zeros((1, n_fine, 3))
    T = delta + DELTA
    fine_dt = T / (n_fine - 1)
    n_lobe = int(np.round(delta / fine_dt))
    waveform[0, 1:n_lobe, 0] = 1.0
    waveform[0, -n_lobe:-1, 0] = -1.0
    gradient, dt = interpolate_gradient(waveform, fine_dt, n_t)
    gradient = np.repeat(gradient, len(bvals), axis=0)
    gradient = set_b(gradient, dt, bvals)
    Rs = np.stack(
        [utils.vec2vec_rotmat(np.array([1.0, 0.0, 0.0]), bvec) for bvec in bvecs]
    )
    return rotate_gradient(gradient, Rs), dt


def ogse(delta, DELTA, frequency, n_t, bvals, bvecs, waveform="cos"):
    """Synthesize an oscillating-gradient spin-echo (OGSE) waveform set.

    Two oscillating lobes of duration ``delta`` whose onsets are ``DELTA``
    apart; the second lobe is inverted (spin-echo refocusing). An addition
    over the reference toolkit: OGSE probes shorter diffusion times than
    PGSE can reach, which is the standard sequence for small restrictions.

    Parameters
    ----------
    delta : float
        Lobe duration (s). ``delta * frequency`` should be an integer so
        each lobe holds a whole number of periods.
    DELTA : float
        Lobe-onset separation (s).
    frequency : float
        Oscillation frequency (Hz).
    n_t : int
        Number of time points in the returned gradient array.
    bvals : float or numpy.ndarray
        b-value(s) (s/m^2).
    bvecs : numpy.ndarray
        Unit b-vector(s), shape (n of measurements, 3) (or (3,) for one).
    waveform : str, optional
        "cos" (apodised cosine: sine quarter-period ramps at the lobe ends,
        zero net q at all times inside the lobe) or "sin".

    Returns
    -------
    gradient : numpy.ndarray
        Gradient array of shape (n of measurements, n_t, 3).
    dt : float
        Time-step duration (s).
    """
    if waveform not in ("sin", "cos"):
        raise ValueError(f"Incorrect value ({waveform}) for waveform")
    bvals = np.atleast_1d(np.asarray(bvals, dtype=float))
    bvecs = np.atleast_2d(np.asarray(bvecs, dtype=float))
    n_fine = int(1e6)
    T = delta + DELTA
    fine_dt = T / (n_fine - 1)
    t = np.arange(n_fine) * fine_dt
    lobe = np.zeros(n_fine)
    in_first = t < delta
    in_second = t >= DELTA
    if waveform == "sin":
        shape_first = np.sin(2 * np.pi * frequency * t)
        shape_second = np.sin(2 * np.pi * frequency * (t - DELTA))
    else:
        # Apodised cosine (Does et al., MRM 2003): the first and last
        # quarter-cycles of the cosine are replaced by half-cycles of a sine
        # at twice the frequency, giving zero ends, continuity, and zero
        # net integral per lobe.
        def apodised(tau):
            quarter = 1.0 / (4 * frequency)
            head = np.sin(4 * np.pi * frequency * tau)
            body = np.cos(2 * np.pi * frequency * tau)
            tail = np.sin(4 * np.pi * frequency * (delta - tau))
            return np.where(
                tau < quarter,
                head,
                np.where(tau > delta - quarter, tail, body),
            )

        shape_first = apodised(t)
        shape_second = apodised(t - DELTA)
    lobe = np.where(in_first, shape_first, 0.0) - np.where(
        in_second, shape_second, 0.0
    )
    gradient = np.zeros((1, n_fine, 3))
    gradient[0, :, 0] = lobe
    gradient, dt = interpolate_gradient(gradient, fine_dt, n_t)
    gradient = np.repeat(gradient, len(bvals), axis=0)
    gradient = set_b(gradient, dt, bvals)
    Rs = np.stack(
        [utils.vec2vec_rotmat(np.array([1.0, 0.0, 0.0]), bvec) for bvec in bvecs]
    )
    return rotate_gradient(gradient, Rs), dt


def load_camino_scheme_file(path):
    """Load a Camino ``GRADIENT_WAVEFORM`` scheme file as a gradient array.

    All waveforms in the file must share the same number of time points and
    the same time-step duration. See
    http://camino.cs.ucl.ac.uk/index.php?n=Tutorials.GenwaveTutorial.

    Parameters
    ----------
    path : str
        Path to the scheme file.

    Returns
    -------
    gradient : numpy.ndarray
        Gradient array of shape (n of measurements, n of time points, 3).
    dt : float
        Time-step duration (s).

    Notes
    -----
    Parity with reference ``gradients.load_camino_scheme_file``
    (disimpy/gradients.py:182-214), including the exception messages.
    """
    with open(path, "r") as f:
        if f.readline().strip() != "VERSION: GRADIENT_WAVEFORM":
            raise Exception(
                "The scheme file does not start with 'VERSION: GRADIENT_WAVEFORM'"
            )
    scheme = np.loadtxt(path, skiprows=1, ndmin=2)
    dts = scheme[:, 1]
    if len(set(dts)) != 1:
        raise Exception(
            "Not all rows of the scheme file have the same time step duration. "
            "Disimpy does not support scheme files with multiple time step durations."
        )
    gradient = scheme[:, 2:].reshape(len(scheme), -1, 3)
    return gradient, float(dts[0])


def save_camino_scheme_file(path, gradient, dt):
    """Write a gradient array as a Camino ``GRADIENT_WAVEFORM`` scheme file.

    Inverse of :func:`load_camino_scheme_file` (an addition over the
    reference toolkit): row format is ``n_t dt g_x(0) g_y(0) g_z(0) ...``.

    Parameters
    ----------
    path : str
        Output path.
    gradient : numpy.ndarray
        Gradient array of shape (n of measurements, n of time points, 3).
    dt : float
        Time-step duration (s).
    """
    gradient = np.asarray(gradient, dtype=float)
    n_meas, n_t, _ = gradient.shape
    header = np.full((n_meas, 2), dt)
    header[:, 0] = n_t
    rows = np.hstack((header, gradient.reshape(n_meas, -1)))
    with open(path, "w") as f:
        f.write("VERSION: GRADIENT_WAVEFORM\n")
        np.savetxt(f, rows)
