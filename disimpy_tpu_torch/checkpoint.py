"""Checkpoint/resume helpers for long simulations (NumPy only).

The JAX package's ``checkpoint`` module, copied: the same ``.npz`` format,
magic string and ``resume_seed`` mix, so a checkpoint written by either
package loads in the other and a resumed segment gets the same seed.

The reference's only resume path is manual: run with ``final_pos=True``,
keep the positions array, and feed it back through ``substrates.mesh(...,
init_pos=positions)`` (disimpy/substrates.py:175-186). These helpers make
that loop explicit and self-describing: a checkpoint file stores the
walker positions, the simulation seed, and how many time steps have been
consumed, so a follow-up run can continue the physics with fresh,
non-overlapping random streams.

Random-stream correctness: the engine keys its counter-based draws by
(seed, absolute time step). Resuming with the same seed but a different
``seed`` offset would replay the original steps' directions; instead,
:func:`resume_seed` derives a distinct seed from (seed, steps_done), so a
resumed simulation is statistically independent of the completed segment
(the physics of splitting one acquisition into segments is exact for any
piecewise-defined waveform).
"""

import json

import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint", "resume_seed"]

_MAGIC = "disimpy_tpu-checkpoint-v1"


def save_checkpoint(path, positions, seed, steps_done, extra=None):
    """Write a resume checkpoint.

    Parameters
    ----------
    path : str
        Output file (``.npz``).
    positions : numpy.ndarray
        (n_walkers, 3) walker positions (lab frame, metres) — e.g. the
        ``final_pos=True`` return of :func:`simulations.simulation`.
    seed : int
        The seed the completed segment ran with.
    steps_done : int
        Total time steps consumed so far.
    extra : dict, optional
        JSON-serializable metadata stored verbatim.
    """
    positions = np.asarray(positions, dtype=float)
    if positions.ndim != 2 or positions.shape[1] != 3:
        raise ValueError("positions must have shape (n_walkers, 3)")
    # np.savez appends ".npz" when the suffix is missing, which would make
    # load_checkpoint(path) fail for the very path save_checkpoint accepted;
    # normalize here so save/load are symmetric for any path.
    path = str(path)
    if not path.endswith(".npz"):
        path += ".npz"
    np.savez(
        path,
        magic=_MAGIC,
        positions=positions,
        seed=int(seed),
        steps_done=int(steps_done),
        extra=json.dumps(extra or {}),
    )


def load_checkpoint(path):
    """Read a checkpoint written by :func:`save_checkpoint`.

    Returns
    -------
    dict with keys ``positions`` ((n, 3) array), ``seed``, ``steps_done``,
    ``resume_seed`` (the seed to pass to the next segment's
    ``simulation()``), and ``extra``.
    """
    path = str(path)
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path, allow_pickle=False) as data:
        if str(data["magic"]) != _MAGIC:
            raise ValueError(f"{path} is not a disimpy_tpu checkpoint")
        seed = int(data["seed"])
        steps_done = int(data["steps_done"])
        return {
            "positions": np.asarray(data["positions"], dtype=float),
            "seed": seed,
            "steps_done": steps_done,
            "resume_seed": resume_seed(seed, steps_done),
            "extra": json.loads(str(data["extra"])),
        }


def resume_seed(seed, steps_done):
    """Seed for the segment starting after ``steps_done`` steps.

    A fixed integer mix of (seed, steps_done) in the non-negative int32
    range ``simulation()`` accepts; distinct from ``seed`` so resumed
    segments draw independent streams.
    """
    # splitmix64-style mix in plain Python ints masked to 64 bits: the
    # wraparound is intended, and doing it in numpy uint64 scalars emits
    # RuntimeWarnings that break warnings-as-errors setups.
    m = 0xFFFFFFFFFFFFFFFF
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(steps_done) * 0xBF58476D1CE4E5B9) & m
    x ^= x >> 31
    x = (x * 0x94D049BB133111EB) & m
    x ^= x >> 29
    return int(x & 0x7FFFFFFF)
