"""The port's driver (simulation() and run_window_fused) against the JAX
package, on the CPU with the kernel's plain torch version.

The JAX side ran its fused engine with the Pallas kernel in interpret
mode (``config.use_fused = True, config.pallas_interpret = True``), once
per permeability, in ``scripts/make_torch_oracles.py``, which stored the
outputs in ``tests/oracles/jax_reference_runs.npz``. Both engines start
from the same explicit positions and key their kernels with the same threefry streams;
float32 cos/sin of the step directions differ by ~1 ulp between torch and
XLA, so positions are held to 1e-4 step lengths for at least 99% of spins
(measured: all spins within 4e-6) and signals to 1e-5 per spin (measured
3e-8).
"""

import pickle

import numpy as np
import numpy.testing as npt
import pytest
import torch
from scipy.stats import kstest

import jax.numpy as jnp

from disimpy_tpu import gradients as jgrad
from disimpy_tpu import simulations as jsim
from disimpy_tpu import substrates as jsub
from disimpy_tpu.engine import fused as jfused
from disimpy_tpu_torch import gradients, simulations, substrates
from disimpy_tpu_torch.engine import fused

import torch_threads  # noqa: F401  (shares the cores among xdist workers)

D = 2e-9
N_SPINS, N_STEPS, SEED = 512, 10, 3
# ~1.2 um steps against the 5 um cylinder: several bounces per step.
DT = 1.2e-4


def _cylinder_mesh(oracles_dir):
    with open(oracles_dir / "cylinder_mesh_closed.pkl", "rb") as f:
        mesh = pickle.load(f)
    return mesh["vertices"], mesh["faces"]


def _gradient():
    bs = np.linspace(1, 3e9, 4)
    gradient = np.zeros((1, 700, 3))
    gradient[0, 1:300, 0] = 1
    gradient[0, -300:-1, 0] = -1
    gradient = np.concatenate([gradient for _ in bs], axis=0)
    gradient, _ = gradients.interpolate_gradient(gradient, 70e-3 / 699, N_STEPS)
    return gradients.set_b(gradient, DT, bs)


@pytest.fixture(scope="module")
def intra_points(oracles_dir):
    vertices, faces = _cylinder_mesh(oracles_dir)
    sub = substrates.mesh(vertices, faces, True, init_pos="intra",
                          n_sv=np.array([10, 10, 10]), quiet=True)
    return simulations._fill_mesh(N_SPINS, sub, True, 5, "cpu")


@pytest.fixture(scope="module")
def jax_runs(oracles_dir, intra_points):
    """JAX fused simulation() at perm 0 and 0.5 and the run_window_fused
    call it makes at perm 0, stored by ``scripts/make_torch_oracles.py``
    (``simrun_*``, ``window_*``); the window's pack, gradient and epsilon
    are rebuilt here on the host as the script builds them."""
    vertices, faces = _cylinder_mesh(oracles_dir)
    with np.load(oracles_dir / "jax_reference_runs.npz") as data:
        out = {perm: dict(signals=data[f"simrun_signals_{tag}"],
                          pos=data[f"simrun_pos_{tag}"])
               for perm, tag in ((0.0, "p0"), (0.5, "p05"))}
        window = {k: data["window_" + k]
                  for k in ("positions", "phases", "iter_exc")}
    step_l = np.sqrt(6 * D * DT)
    sub = jsub.mesh(vertices, faces, True, init_pos=intra_points,
                    n_sv=np.array([10, 10, 10]), quiet=True)
    gradient = _gradient()
    spec = jfused.pack_fused(sub, 1 / step_l, n_hint=float(N_SPINS))
    g_eff = (jgrad.GAMMA * DT * step_l) * np.transpose(gradient, (1, 0, 2))
    eps = jsim._effective_epsilon(
        1e-13, 1 / step_l, float(np.max(sub.voxel_size)) / step_l,
        N_STEPS, jnp.float32, False)
    out["window"] = dict(spec=spec, g_eff=g_eff, eps=eps, step_l=step_l,
                         **window)
    return out


def test_fill_mesh_equals_jax(oracles_dir, intra_points):
    vertices, faces = _cylinder_mesh(oracles_dir)
    for periodic in (True, False):
        kw = dict(n_sv=np.array([10, 10, 10]), quiet=True)
        sub_j = jsub.mesh(vertices, faces, periodic, **kw)
        sub_t = substrates.mesh(vertices, faces, periodic, **kw)
        for intra in (True, False):
            npt.assert_array_equal(
                simulations._fill_mesh(300, sub_t, intra, 9, "cpu"),
                jsim._fill_mesh(300, sub_j, intra, 9),
            )
    sub_j = jsub.mesh(vertices, faces, True, n_sv=np.array([10, 10, 10]),
                      quiet=True)
    npt.assert_array_equal(intra_points, jsim._fill_mesh(N_SPINS, sub_j, True, 5))


@pytest.mark.parametrize("perm", [0.0, 0.5])
def test_simulation_matches_jax_fused(oracles_dir, intra_points, jax_runs,
                                      perm):
    vertices, faces = _cylinder_mesh(oracles_dir)
    sub = substrates.mesh(vertices, faces, True, init_pos=intra_points,
                          n_sv=np.array([10, 10, 10]), quiet=True,
                          perm_prob=perm)
    signals, pos = simulations.simulation(
        N_SPINS, D, _gradient(), DT, sub, seed=SEED, final_pos=True,
        quiet=True, device="cpu",
    )
    ref = jax_runs[perm]
    npt.assert_allclose(signals / N_SPINS, ref["signals"] / N_SPINS,
                        rtol=0, atol=1e-5)
    step_l = np.sqrt(6 * D * DT)
    err = np.abs(pos - ref["pos"]).max(axis=1) / step_l
    assert np.mean(err <= 1e-4) >= 0.99, np.mean(err <= 1e-4)
    if not perm:
        # Confinement: the impermeable closed cylinder keeps every spin in.
        c = np.asarray(sub.voxel_size) / 2
        r = np.linalg.norm((pos - c)[:, :2], axis=1)
        assert r.max() < 5e-6 * (1 + 1e-3)


def test_run_window_fused_matches_jax(jax_runs, intra_points):
    w = jax_runs["window"]
    arrays = {k: np.asarray(getattr(w["spec"], k)) for k in (
        "table", "cell_start", "cell_packed", "cell_packed2", "voxel_size",
        "sv_width", "perm_prob")}
    meta = {k: getattr(w["spec"], k) for k in (
        "n_sv", "resort_every", "seed_salt", "eps_budget")}
    spec = fused.spec_from_numpy(arrays, meta, "cpu")
    positions, phases, iter_exc = fused.run_window_fused(
        spec,
        torch.as_tensor(intra_points.T * (1.0 / w["step_l"]), dtype=torch.float32),
        torch.zeros((4, N_SPINS)), torch.zeros(N_SPINS, dtype=torch.bool),
        torch.as_tensor(w["g_eff"], dtype=torch.float32), range(N_STEPS),
        SEED, w["eps"], 1000,
    )
    npt.assert_array_equal(iter_exc.numpy(), w["iter_exc"])
    err = np.abs(positions.numpy() - w["positions"]).max(axis=0)
    assert np.mean(err <= 1e-4) >= 0.99, np.mean(err <= 1e-4)
    # Phases are g . r sums over ~1e2 step lengths: float32 resolution.
    npt.assert_allclose(phases.numpy(), w["phases"], rtol=0,
                        atol=1e-4 * np.abs(w["phases"]).max())


def test_uniform_mesh_seeding(oracles_dir):
    # JAX seeds "uniform" with jax.random, which the port cannot match: the
    # port's threefry-keyed seeding is held to uniformity instead.
    vox = np.array([3.0, 5.0, 7.0])
    pos = simulations._uniform_positions(20000, vox, SEED, "cpu").numpy()
    for axis in range(3):
        assert kstest(pos[axis] / vox[axis], "uniform").pvalue > 1e-3
    other = simulations._uniform_positions(20000, vox, SEED + 1, "cpu")
    assert not np.array_equal(pos, other.numpy())
    # Through simulation(): spins seeded on both sides of the closed
    # cylinder's wall stay on their side.
    vertices, faces = _cylinder_mesh(oracles_dir)
    sub = substrates.mesh(vertices, faces, True, n_sv=np.array([10, 10, 10]),
                          quiet=True)
    n = 256
    signals, end = simulations.simulation(
        n, D, _gradient(), DT, sub, seed=SEED, final_pos=True, quiet=True,
        device="cpu",
    )
    assert np.all(np.isfinite(signals)) and np.all(np.abs(signals) <= n)
    step_l = np.sqrt(6 * D * DT)
    start = simulations._uniform_positions(
        n, np.asarray(sub.voxel_size) / step_l, SEED, "cpu"
    ).numpy().T.astype(float) * step_l
    classify = simulations._make_intra_classifier(sub, "cpu")
    inside = classify(start)
    assert 0 < inside.sum() < n
    npt.assert_array_equal(
        classify(np.mod(end, np.asarray(sub.voxel_size))), inside)


def test_free_diffusion_matches_exp_bd():
    bvals = np.linspace(1, 3e9, 16)
    bvecs = np.tile([[1.0, 0.0, 0.0]], (16, 1))
    gradient, dt = gradients.pgse(20e-3, 40e-3, 1000, bvals, bvecs)
    n = 100000
    signals = simulations.simulation(n, D, gradient, dt, substrates.free(),
                                     quiet=True, device="cpu")
    # Monte Carlo error of a 1e5-spin mean is ~0.002 at mid b (measured
    # 0.0022 here; 1e4 spins or 100 steps leave too little margin).
    assert np.abs(signals / n - np.exp(-bvals * D)).max() <= 0.01
    per_spin = simulations.simulation(2000, D, gradient[:, :50], dt,
                                      substrates.free(), quiet=True,
                                      device="cpu", all_signals=True)
    total = simulations.simulation(2000, D, gradient[:, :50], dt,
                                   substrates.free(), quiet=True,
                                   device="cpu")
    npt.assert_allclose(per_spin.sum(axis=1), total, rtol=1e-5)


def test_simulation_validation():
    bvals = np.array([1e9])
    gradient, dt = gradients.pgse(10e-3, 20e-3, 20, bvals, np.eye(3)[:1])
    ok = dict(n_walkers=10, diffusivity=D, gradient=gradient, dt=dt,
              substrate=substrates.free(), quiet=True, device="cpu")
    for bad in (
        dict(n_walkers=0), dict(n_walkers=1.5), dict(diffusivity=0.0),
        dict(diffusivity=1), dict(gradient=gradient[0]),
        dict(gradient=gradient.astype(int)), dict(gradient="g"),
        dict(dt=-1.0), dict(dt=1), dict(substrate="s"), dict(seed=-1),
        dict(seed=1.5), dict(traj=5), dict(quiet=1), dict(cuda_bs=0),
        dict(max_iter=0), dict(dtype="int8"),
    ):
        with pytest.raises(ValueError):
            simulations.simulation(**{**ok, **bad})


def test_unported_paths_raise(oracles_dir):
    # Slice 3 runs relaxation, exchange_stats and devices; what is left to
    # raise are the JAX package's ValueErrors for malformed values of them
    # (tests/test_exchange.py::test_relaxation_validation) and for devices
    # that are unknown, missing or in conflict with ``device``.
    bvals = np.array([1e9])
    gradient, dt = gradients.pgse(10e-3, 20e-3, 20, bvals, np.eye(3)[:1])
    vertices, faces = _cylinder_mesh(oracles_dir)
    mesh = substrates.mesh(vertices, faces, True, quiet=True,
                           n_sv=np.array([10, 10, 10]))
    ok = dict(n_walkers=10, diffusivity=D, gradient=gradient, dt=dt,
              substrate=substrates.free(), quiet=True, device="cpu")
    missing = torch.cuda.device_count() + 1
    for bad in (
        dict(relaxation=(30e-3, 100e-3)), dict(relaxation=-1.0),
        dict(relaxation=(1.0, 2.0, 3.0)), dict(relaxation=(0.05, -0.08)),
        dict(relaxation=True), dict(relaxation="0.05"),
        dict(substrate=mesh, relaxation=(0.05, 0.0)),
        dict(exchange_stats="yes"), dict(substrate=mesh, exchange_stats=1),
        dict(devices=0), dict(devices=-1), dict(devices=True),
        dict(devices=[]), dict(devices=["tpu:0"]), dict(devices="nodev"),
        dict(devices=missing, device=None),
        dict(devices=[f"cuda:{missing}"], device=None),
        dict(devices=["cpu", "cpu"], device="cuda:0"),
    ):
        with pytest.raises(ValueError):
            simulations.simulation(**{**ok, **bad})


def test_cuda_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: nothing to refuse")
    bvals = np.array([1e9])
    gradient, dt = gradients.pgse(10e-3, 20e-3, 20, bvals, np.eye(3)[:1])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        simulations.simulation(10, D, gradient, dt, substrates.free(),
                               quiet=True)


def test_tf32_matmuls_are_refused():
    bvals = np.array([1e9])
    gradient, dt = gradients.pgse(10e-3, 20e-3, 20, bvals, np.eye(3)[:1])
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="full float32"):
            simulations.simulation(10, D, gradient, dt, substrates.free(),
                                   quiet=True, device="cpu")
    finally:
        torch.set_float32_matmul_precision("highest")
