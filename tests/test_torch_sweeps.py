"""The port's radius sweeps against its standalone runs and the JAX
package's sweeps.

Row i of a sweep is the port's ``simulation()`` of variant i with the same
seed (the variants share the id-keyed streams). The JAX package's sweeps
draw from ``jax.random``, so they are held to the port statistically:
within 4 Monte Carlo standard errors per measurement, at 2000 spins
(``disimpy_tpu.sweeps`` outputs stored by ``scripts/make_torch_oracles.py``
as ``sweep_*`` in ``tests/oracles/jax_reference_runs.npz``).
"""

import numpy as np
import numpy.testing as npt
import pytest

from disimpy_tpu_torch import gradients, simulations, substrates, sweeps

import torch_threads  # noqa: F401  (shares the cores among xdist workers)

D = 2e-9
ORIENTATION = np.array([0.0, 1.0, 1.0])


def example_gradient(n_t=100):
    T = 80e-3
    gradient = np.zeros((1, 100, 3))
    gradient[0, 1:11, 0] = 1
    gradient[0, -11:-1, 0] = -1
    dt = T / (gradient.shape[1] - 1)
    return gradients.interpolate_gradient(gradient, dt, n_t)


def _standalone(n, substrate, **kw):
    gradient, dt = example_gradient()
    return simulations.simulation(n, D, gradient, dt, substrate, quiet=True,
                                  device="cpu", **kw)


def test_cylinder_radius_sweep_matches_standalone_runs():
    gradient, dt = example_gradient()
    radii = np.linspace(1e-6, 8e-6, 8)
    swept = sweeps.sweep_cylinder_radii(
        400, D, gradient, dt, radii, orientation=ORIENTATION, device="cpu"
    )
    assert swept.shape == (8, 1)
    singles = np.stack([
        _standalone(400, substrates.cylinder(radius=float(r),
                                             orientation=ORIENTATION))
        for r in radii
    ])
    # Row i of the sweep is the standalone simulation with the same seed.
    npt.assert_allclose(swept, singles, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sphere_radius_sweep_matches_standalone_runs(dtype):
    gradient, dt = example_gradient()
    radii = np.array([2e-6, 5e-6, 10e-6])
    swept = sweeps.sweep_sphere_radii(300, D, gradient, dt, radii,
                                      dtype=dtype, device="cpu")
    singles = np.stack([
        _standalone(300, substrates.sphere(float(r)), dtype=dtype)
        for r in radii
    ])
    npt.assert_allclose(swept, singles, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("kind", ["sphere", "cylinder"])
def test_sweeps_agree_with_jax(oracles_dir, kind):
    # The radii and spin count of scripts/make_torch_oracles.py. The
    # gradient doubled, as a second measurement, gives sum cos(2 phi), so
    # the per-spin variance of cos(phi) is (1 + E cos 2phi) / 2 - E^2 cos
    # phi; two independent n-spin sums differ by sqrt(2 n var) (1 SE).
    n = 2000
    gradient, dt = example_gradient()
    gradient = np.concatenate([gradient, 2 * gradient])
    with np.load(oracles_dir / "jax_reference_runs.npz") as data:
        ref = data[f"sweep_{kind}"]
    if kind == "sphere":
        swept = sweeps.sweep_sphere_radii(
            n, D, gradient, dt, np.array([2e-6, 5e-6, 10e-6]), device="cpu")
    else:
        swept = sweeps.sweep_cylinder_radii(
            n, D, gradient, dt, np.array([1e-6, 4e-6, 8e-6]),
            orientation=ORIENTATION, device="cpu")
    assert swept.shape == (3, 2) and ref.shape == (3, 1)
    mean, mean2 = swept[:, 0] / n, swept[:, 1] / n
    se = np.sqrt(2 * n * ((1 + mean2) / 2 - mean**2))
    assert np.all(np.abs(swept[:, 0] - ref[:, 0]) <= 4 * se), (swept, ref, se)
