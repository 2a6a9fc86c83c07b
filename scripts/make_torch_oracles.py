"""Write the JAX package's outputs that the port's CPU tests compare against.

    JAX_PLATFORMS=cpu python scripts/make_torch_oracles.py

Runs, on the CPU, the JAX package calls whose compiles no test fixture
already pays for, and stores their outputs in
``tests/oracles/jax_reference_runs.npz`` (a few tens of kB). Each key is
prefixed by the run it comes from:

- ``fused_*``: ``disimpy_tpu.simulations.simulation`` with the fused engine
  in Pallas interpret mode (``config.use_fused = True, pallas_interpret =
  True``) on the 512-spin, 10-step, perm 0.5 closed-cylinder setup of
  ``tests/test_torch_simulation.py``, with ``exchange_stats=True``,
  ``relaxation=(25e-3, 150e-3)``, ``all_signals=True`` and
  ``final_pos=True``: per-spin signals, final positions, crossings and
  intra steps;
- ``sphere_*``: ``simulation`` on ``substrates.sphere(5e-6,
  perm_prob=0.5)`` (the classic engine), 1200 spins x 60 steps, dt 2e-4,
  b = 0, seed 5, ``exchange_stats=True`` (the setup of
  ``tests/test_permeability.py``): crossings and intra steps;
- ``sweep_sphere`` / ``sweep_cylinder``: ``disimpy_tpu.sweeps`` at 2000
  spins on the 100-step gradient of ``tests/test_sweeps.py``, sphere radii
  (2, 5, 10) um and cylinder radii (1, 4, 8) um along (0, 1, 1).

The inputs are rebuilt the same way by ``tests/test_torch_exchange.py`` and
``tests/test_torch_sweeps.py``; rerun this script when the JAX package or
those setups change.
"""

import os
import pathlib
import pickle
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from disimpy_tpu import gradients, simulations, substrates, sweeps  # noqa: E402
from disimpy_tpu.engine import config  # noqa: E402

OUT = ROOT / "tests" / "oracles" / "jax_reference_runs.npz"
D = 2e-9

# The fused setup (tests/test_torch_simulation.py).
FUSED_SPINS, FUSED_STEPS, FUSED_SEED, FUSED_DT = 512, 10, 3, 1.2e-4
RELAXATION = (25e-3, 150e-3)
# The analytic setup (tests/test_permeability.py).
SPHERE_SPINS, SPHERE_STEPS, SPHERE_SEED = 1200, 60, 5
# The sweeps (tests/test_sweeps.py gradient, more spins).
SWEEP_SPINS = 2000
SPHERE_RADII = np.array([2e-6, 5e-6, 10e-6])
CYLINDER_RADII = np.array([1e-6, 4e-6, 8e-6])
ORIENTATION = np.array([0.0, 1.0, 1.0])


def fused_gradient():
    """The 4-b PGSE gradient of tests/test_torch_simulation.py."""
    bs = np.linspace(1, 3e9, 4)
    gradient = np.zeros((1, 700, 3))
    gradient[0, 1:300, 0] = 1
    gradient[0, -300:-1, 0] = -1
    gradient = np.concatenate([gradient for _ in bs], axis=0)
    gradient, _ = gradients.interpolate_gradient(gradient, 70e-3 / 699,
                                                 FUSED_STEPS)
    return gradients.set_b(gradient, FUSED_DT, bs)


def sweep_gradient(n_t=100):
    """The gradient of tests/test_sweeps.py."""
    gradient = np.zeros((1, 100, 3))
    gradient[0, 1:11, 0] = 1
    gradient[0, -11:-1, 0] = -1
    return gradients.interpolate_gradient(gradient, 80e-3 / 99, n_t)


def main():
    out = {}
    with open(ROOT / "tests" / "oracles" / "cylinder_mesh_closed.pkl",
              "rb") as f:
        mesh = pickle.load(f)
    kw = dict(n_sv=np.array([10, 10, 10]), quiet=True)
    start = simulations._fill_mesh(
        FUSED_SPINS, substrates.mesh(mesh["vertices"], mesh["faces"], True,
                                     **kw), True, 5)
    sub = substrates.mesh(mesh["vertices"], mesh["faces"], True,
                          init_pos=start, perm_prob=0.5, **kw)
    try:
        config.use_fused = True
        config.pallas_interpret = True
        signals, pos, stats = simulations.simulation(
            FUSED_SPINS, D, fused_gradient(), FUSED_DT, sub, seed=FUSED_SEED,
            final_pos=True, all_signals=True, quiet=True,
            relaxation=RELAXATION, exchange_stats=True,
        )
    finally:
        config.use_fused = None
        config.pallas_interpret = False
    out.update(fused_signals=signals, fused_pos=pos,
               fused_crossings=stats["crossings"],
               fused_intra_steps=stats["intra_steps"])

    _, stats = simulations.simulation(
        SPHERE_SPINS, D, np.zeros((1, SPHERE_STEPS, 3)), 2e-4,
        substrates.sphere(5e-6, perm_prob=0.5), quiet=True, seed=SPHERE_SEED,
        exchange_stats=True,
    )
    out.update(sphere_crossings=stats["crossings"],
               sphere_intra_steps=stats["intra_steps"])

    gradient, dt = sweep_gradient()
    out["sweep_sphere"] = sweeps.sweep_sphere_radii(
        SWEEP_SPINS, D, gradient, dt, SPHERE_RADII)
    out["sweep_cylinder"] = sweeps.sweep_cylinder_radii(
        SWEEP_SPINS, D, gradient, dt, CYLINDER_RADII,
        orientation=ORIENTATION)

    np.savez_compressed(OUT, **{k: np.asarray(v) for k, v in out.items()})
    print(f"{OUT.relative_to(ROOT)}: "
          + ", ".join(f"{k} {np.asarray(v).shape}" for k, v in out.items()))


if __name__ == "__main__":
    main()
