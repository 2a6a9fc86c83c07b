"""The classic engine's random draws, keyed per (seed, step, spin id).

The JAX package's classic engine draws from JAX's own key-split random
generator per (seed, step, bounce); the port cannot reproduce those bits
and does not try. It
keys every draw with the threefry streams of ``engine/krng.py`` instead,
by spin id, so a spin's stream does not depend on where it sits in the
ensemble: the compaction in ``stepping.step_mesh`` cannot change it.

A step function takes its draws as two arguments, so a test can feed it
another engine's draws:

- ``directions``: (3, n) unit step directions;
- ``uniform(bounce, idx)``: permeability uniforms for the spins at
  positions ``idx`` of the ensemble (an int64 tensor, or None for all of
  them), at collision ``bounce`` (an int, or a tensor matching ``idx``).
"""

from . import krng


def step_directions(seed_k, t, ids, dtype):
    """(3, n) isotropic unit directions for time step ``t``."""
    return krng.unit_directions(seed_k, int(t), ids, dtype)


def bounce_uniforms(seed_k, t, ids, dtype):
    """The ``uniform(bounce, idx)`` callable for time step ``t``."""

    def uniform(bounce, idx=None):
        sel = ids if idx is None else ids[idx]
        return krng.bounce_uniform(seed_k, int(t), sel, bounce, dtype)

    return uniform
