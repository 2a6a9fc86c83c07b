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

Both come from ``engine/draw_kernel.py``: one launch of the draw kernel
(``csrc/krng_draw.cu``) per step and per bounce pass on a CUDA device, the
plain krng functions on the CPU. The classic step kernels
(``engine/analytic_kernel.py``, ``engine/mesh_kernel.py``) draw the same
values in-kernel. ``seed_k`` and ``t`` are Python ints or 0-d int32 tensors
on the ids' device; tensors are read where they lie, so the classic window
(``engine/core.py``) can advance the step on the device.
"""

import torch

from . import draw_kernel


def step_directions(seed_k, t, ids, dtype):
    """(3, n) isotropic unit directions for time step ``t``."""
    if not isinstance(t, torch.Tensor):
        t = int(t)
    return draw_kernel.unit_directions_epoch(seed_k, t, 1, ids, dtype)[0]


def bounce_uniforms(seed_k, t, ids, dtype):
    """The ``uniform(bounce, idx)`` callable for time step ``t``."""
    key = (seed_k, t)
    if ids.device.type == "cuda" and not all(
            isinstance(v, torch.Tensor) for v in key):
        # One copy of the step's scalars serves every bounce pass.
        key = tuple(draw_kernel.device_scalars([int(v) for v in key],
                                               ids.device))

    def uniform(bounce, idx=None):
        return draw_kernel.bounce_uniform(*key, ids, bounce, idx, dtype)

    return uniform
