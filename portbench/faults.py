"""Faults planted under the timed path, each of which the comparison must
read as not correct. Each is a ``program`` for ``run.run``: it is called
as ``fault(simulation, *args, **kwargs)`` in the place of
``simulation(*args, **kwargs)``."""

import numpy as np


def unchanged(sim, *args, **kwargs):
    """A window that returns the state it was given."""
    from disimpy_tpu_torch.engine import core, fused

    def fused_window(spec, positions, phases, iter_exc, *a, **k):
        return positions, phases, iter_exc

    def classic_window(kind, spec, positions, phases, iter_exc, *a, **k):
        return (positions, phases, iter_exc), None

    saved = fused.run_window_fused, core.run_window
    fused.run_window_fused, core.run_window = fused_window, classic_window
    try:
        return sim(*args, **kwargs)
    finally:
        fused.run_window_fused, core.run_window = saved


def half_batch(sim, n, diffusivity, gradient, dt, substrate, **kwargs):
    """Half of the spins left out, the signal scaled up from the rest and
    the rest's final positions standing in for theirs."""
    start = substrate.init_pos
    if isinstance(start, np.ndarray):
        substrate.init_pos = start[:n // 2]
    try:
        out = sim(n // 2, diffusivity, gradient, dt, substrate, **kwargs)
    finally:
        substrate.init_pos = start
    if isinstance(out, tuple):
        return (2.0 * out[0], np.concatenate([out[1], out[1]])[:n],
                *out[2:])
    return 2.0 * out


def altered(sim, *args, **kwargs):
    """Two measurements' signals exchanged where they are produced."""
    out = sim(*args, **kwargs)
    signal = out[0] if isinstance(out, tuple) else out
    signal[[0, -1]] = signal[[-1, 0]]
    return out


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered}
