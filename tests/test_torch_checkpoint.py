"""The port's checkpoint module against the JAX package's.

The two share one ``.npz`` format and one ``resume_seed`` mix: a file
written by either loads in the other, and a resumed segment gets the same
seed from both.
"""

import numpy as np
import numpy.testing as npt
import pytest

from disimpy_tpu import checkpoint as jcheckpoint
from disimpy_tpu_torch import checkpoint, gradients, meshes, simulations, substrates

import torch_threads  # noqa: F401  (shares the cores among xdist workers)


def test_checkpoint_roundtrip(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    pos = np.random.RandomState(0).random_sample((50, 3)) * 1e-5
    checkpoint.save_checkpoint(path, pos, seed=42, steps_done=100,
                               extra={"note": "segment 1"})
    ck = checkpoint.load_checkpoint(path)
    npt.assert_equal(ck["positions"], pos)
    assert ck["seed"] == 42 and ck["steps_done"] == 100
    assert ck["extra"] == {"note": "segment 1"}
    assert 0 <= ck["resume_seed"] < 2**31
    assert ck["resume_seed"] != 42
    # deterministic, and sensitive to both inputs
    assert ck["resume_seed"] == checkpoint.resume_seed(42, 100)
    assert checkpoint.resume_seed(42, 101) != ck["resume_seed"]
    assert checkpoint.resume_seed(43, 100) != ck["resume_seed"]
    # a path without the suffix saves and loads the same file
    checkpoint.save_checkpoint(str(tmp_path / "plain"), pos, 1, 2)
    assert checkpoint.load_checkpoint(str(tmp_path / "plain.npz"))["seed"] == 1
    with pytest.raises(ValueError):
        checkpoint.save_checkpoint(path, pos[:, :2], 1, 2)
    np.savez(str(tmp_path / "other.npz"), magic="something else")
    with pytest.raises(ValueError):
        checkpoint.load_checkpoint(str(tmp_path / "other.npz"))


def test_resume_seed_equals_jax():
    seeds = [0, 1, 7, 123, 2**16 + 3, 2**31 - 1]
    steps = [0, 1, 50, 999, 10**6, 2**40]
    for seed in seeds:
        for done in steps:
            assert checkpoint.resume_seed(seed, done) == \
                jcheckpoint.resume_seed(seed, done)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_files_load_in_either_package(tmp_path, writer):
    path = str(tmp_path / "ck.npz")
    pos = np.random.RandomState(1).random_sample((20, 3)) * 1e-5
    save = (checkpoint if writer == "port" else jcheckpoint).save_checkpoint
    save(path, pos, seed=9, steps_done=30, extra={"by": writer})
    a = checkpoint.load_checkpoint(path)
    b = jcheckpoint.load_checkpoint(path)
    npt.assert_array_equal(a["positions"], b["positions"])
    for key in ("seed", "steps_done", "resume_seed", "extra"):
        assert a[key] == b[key]
    assert a["extra"] == {"by": writer}


def test_resume_through_mesh_substrate(tmp_path):
    """A two-segment run stays leak-free and statistically consistent with
    a single run of the total length."""
    n_s, n_t = 400, 60
    T = 80e-3
    g = np.zeros((1, 100, 3))
    g[0, 1:11, 0] = 1
    g[0, -11:-1, 0] = -1
    g, dt = gradients.interpolate_gradient(g, T / 99, n_t)
    vertices, faces = meshes.icosphere(radius=5e-6, subdivisions=1)

    sub = substrates.mesh(vertices, faces, False, init_pos="intra",
                          n_sv=np.array([3, 3, 3]), quiet=True)
    _, pos1 = simulations.simulation(
        n_s, 2e-9, g[:, : n_t // 2], dt, sub, final_pos=True, quiet=True,
        device="cpu")
    path = str(tmp_path / "seg.npz")
    checkpoint.save_checkpoint(path, pos1, seed=123, steps_done=n_t // 2)
    ck = checkpoint.load_checkpoint(path)

    sub2 = substrates.mesh(vertices, faces, False,
                           init_pos=ck["positions"],
                           n_sv=np.array([3, 3, 3]), quiet=True)
    _, pos2 = simulations.simulation(
        n_s, 2e-9, g[:, n_t // 2:], dt, sub2, final_pos=True,
        seed=ck["resume_seed"], quiet=True, device="cpu")
    # Confined through both segments (closed icosphere, non-periodic).
    c = np.asarray(sub.voxel_size) / 2
    assert np.linalg.norm(pos2 - c, axis=1).max() < 5e-6 * (1 + 1e-3)
    # Mean squared displacement across both segments is consistent with a
    # restricted walk of the full duration (loose statistical check).
    full_msd = ((pos2 - c) ** 2).sum(axis=1).mean()
    assert 0 < full_msd < (5e-6) ** 2
    assert not np.array_equal(pos2, pos1)
