"""Host NumPy modules of the PyTorch port against the JAX package.

``gradients``, ``substrates``, ``meshes`` and ``utils`` are NumPy code
copied into ``disimpy_tpu_torch``; every comparison here is exact (the
same float64 operations in the same order give the same bits), plus the
reference's golden values.
"""

import pickle

import numpy as np
import numpy.testing as npt
import pytest

from disimpy_tpu import gradients as jgrad
from disimpy_tpu import meshes as jmesh
from disimpy_tpu import substrates as jsub
from disimpy_tpu import utils as jutils
from disimpy_tpu_torch import gradients, meshes, substrates, utils

import torch_threads


def _example_gradient(n_t=1000, amplitude=0.1, lobe=200):
    gradient = np.zeros((1, n_t, 3))
    gradient[0, 1 : lobe + 1, 0] = amplitude
    gradient[0, -(lobe + 1) : -1, 0] = -amplitude
    return gradient, 80e-3 / (n_t - 1)


def test_calc_b_golden_and_equal():
    gradient, dt = _example_gradient()
    b = gradients.calc_b(gradient, dt)
    # The reference's known value (disimpy/tests/test_gradients.py).
    npt.assert_almost_equal(b / 1.07507347e10, 1)
    npt.assert_array_equal(b, jgrad.calc_b(gradient, dt))


def test_gradient_toolkit_equals_jax():
    rng = np.random.RandomState(0)
    bvals = rng.uniform(1e8, 3e9, 5)
    bvecs = rng.normal(size=(5, 3))
    bvecs /= np.linalg.norm(bvecs, axis=1, keepdims=True)
    for fn, args in (
        ("pgse", (10e-3, 30e-3, 500, bvals, bvecs)),
        ("ogse", (20e-3, 30e-3, 100.0, 400, bvals, bvecs)),
    ):
        g_t, dt_t = getattr(gradients, fn)(*args)
        g_j, dt_j = getattr(jgrad, fn)(*args)
        npt.assert_array_equal(g_t, g_j)
        assert dt_t == dt_j
    g, dt = gradients.pgse(10e-3, 30e-3, 500, bvals, bvecs)
    npt.assert_array_equal(
        gradients.interpolate_gradient(g, dt, 321)[0],
        jgrad.interpolate_gradient(g, dt, 321)[0],
    )
    npt.assert_array_equal(gradients.calc_q(g, dt), jgrad.calc_q(g, dt))
    npt.assert_array_equal(
        gradients.set_b(g, dt, bvals[::-1]), jgrad.set_b(g, dt, bvals[::-1])
    )
    Rs = np.stack([utils.vec2vec_rotmat(np.array([1.0, 0, 0]), v)
                   for v in bvecs])
    npt.assert_array_equal(
        gradients.rotate_gradient(g, Rs), jgrad.rotate_gradient(g, Rs)
    )


def test_vec2vec_rotmat_equals_jax():
    rng = np.random.RandomState(1)
    for _ in range(20):
        v, k = rng.normal(size=3), rng.normal(size=3)
        npt.assert_array_equal(
            utils.vec2vec_rotmat(v, k), jutils.vec2vec_rotmat(v, k)
        )


@pytest.mark.parametrize(
    "make",
    [
        lambda m: m.icosphere(radius=5e-6, subdivisions=2),
        lambda m: m.cylinder_mesh(5e-6, 20e-6, 32, 8, closed=True),
        lambda m: m.cylinder_array_mesh(1.5e-6, 4e-6, grid=(2, 3),
                                        n_facets=16, n_segments=3),
    ],
    ids=["icosphere", "cylinder_closed", "cylinder_array"],
)
def test_mesh_generators_equal_jax(make):
    v_t, f_t = make(meshes)
    v_j, f_j = make(jmesh)
    npt.assert_array_equal(v_t, v_j)
    npt.assert_array_equal(f_t, f_j)


def test_mesh_space_subdivision_golden(oracles_dir):
    with open(oracles_dir / "sphere_mesh.pkl", "rb") as f:
        mesh = pickle.load(f)
    vertices, faces = mesh["vertices"], mesh["faces"]
    voxel_size = np.max(vertices, axis=0)
    n_sv = np.array([2, 5, 10])
    out = substrates._mesh_space_subdivision(vertices, faces, voxel_size, n_sv)
    # The reference's golden subdivision output.
    npt.assert_array_equal(
        out[3], np.load(oracles_dir / "desired_triangle_indices.npy")
    )
    npt.assert_array_equal(
        out[4], np.load(oracles_dir / "desired_subvoxel_indices.npy")
    )


@pytest.mark.parametrize("periodic", [True, False])
def test_mesh_substrate_equals_jax(oracles_dir, periodic):
    with open(oracles_dir / "cylinder_mesh_closed.pkl", "rb") as f:
        mesh = pickle.load(f)
    kw = dict(padding=np.full(3, 1e-6), n_sv=np.array([6, 7, 8]), quiet=True)
    s_t = substrates.mesh(mesh["vertices"], mesh["faces"], periodic, **kw)
    s_j = jsub.mesh(mesh["vertices"], mesh["faces"], periodic, **kw)
    for name in ("vertices", "faces", "voxel_size", "xs", "ys", "zs",
                 "triangle_indices", "subvoxel_indices", "n_sv"):
        npt.assert_array_equal(getattr(s_t, name), getattr(s_j, name))
    with pytest.raises(ValueError):
        substrates.mesh(mesh["vertices"], mesh["faces"], "yes", quiet=True)


def test_package_test_runners_call_pytest_on_the_port_tests(monkeypatch):
    import pathlib

    import disimpy_tpu_torch
    import disimpy_tpu_torch.tests as port_tests

    calls = []
    monkeypatch.setattr(pytest, "main", lambda args: calls.append(args) or 0)
    assert disimpy_tpu_torch.test(["-q"]) == 0
    assert port_tests.test_all(["-x"]) == 0
    files = sorted(str(p) for p in
                   pathlib.Path(__file__).parent.glob("test_torch_*.py"))
    assert __file__ in files and len(files) > 10
    assert calls == [[*files, "-q"], [*files, "-x"]]


def test_xdist_workers_share_the_cores_among_torch_threads():
    import torch

    n_threads = torch_threads.threads_per_worker()
    if n_threads is None:
        pytest.skip("not an xdist worker: torch keeps its default threads")
    # tests/torch_threads.py gives each worker cores // workers torch
    # threads, so that the workers' OpenMP regions do not wait on one another.
    assert torch.get_num_threads() == n_threads
