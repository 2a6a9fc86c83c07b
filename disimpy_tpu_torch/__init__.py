"""disimpy_tpu_torch: the diffusion-MRI Monte Carlo simulator on PyTorch.

A port of the JAX package ``disimpy_tpu`` (which stays the reference) to
PyTorch with hand-written CUDA kernels for NVIDIA Hopper GPUs. It keeps
the JAX package's module names and public API; ``simulation()`` takes an
extra ``device`` argument ("cuda" by default). This package imports
neither JAX nor ``disimpy_tpu``.

Modules
-------
checkpoint
    Resume checkpoints (the JAX package's ``.npz`` format).
gradients
    Gradient-waveform toolkit (synthesis, b-value math, rotation, Camino IO).
substrates
    Substrate factories and mesh preprocessing (acceleration grid).
meshes
    Procedural triangular-mesh generators and STL/PLY IO.
simulations
    The simulation driver and noise utilities.
sweeps
    Radius sweeps: many cylinder or sphere variants in one ensemble.
parallel
    Splitting spins over several devices.
utils
    Rotation helpers and optional matplotlib visualization.
engine
    The torch compute core and the CUDA kernel bindings.
tests
    ``test_all()``, which runs the port's tests from a repository checkout.
"""

from . import (checkpoint, gradients, meshes, parallel, simulations,
               substrates, sweeps, utils)

__version__ = "0.1.0"

__all__ = ["checkpoint", "gradients", "meshes", "parallel", "simulations",
           "substrates", "sweeps", "utils", "__version__"]


def test(args=()):
    """Run the port's tests (``tests/test_torch_*.py`` of the repository
    checkout) with pytest and return its exit code; the counterpart of
    ``disimpy_tpu.test()``."""
    from .tests import test_all

    return test_all(args)
