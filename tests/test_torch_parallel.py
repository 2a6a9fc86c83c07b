"""Splitting spins over devices (``simulation(devices=...)``), on the CPU.

A split run gives each part a contiguous range of spins keyed by their
global ids, so every spin walks as in the single run: final positions,
crossings and intra steps must be equal bit for bit, per spin, for both
engines and every seeding; signals are sums of per-part sums and agree to
float32 rounding (1e-6 of the spin count).
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

from disimpy_tpu_torch import gradients, meshes, parallel, simulations, substrates
from disimpy_tpu_torch.engine import config
from disimpy_tpu_torch.engine.specs import SphereSpec

import torch_threads  # noqa: F401  (shares the cores among xdist workers)

D = 2e-9
N_SPINS = 250  # not divisible by 3: the parts differ in size


def _gradient(n_t):
    gradient = np.zeros((1, 100, 3))
    gradient[0, 1:11, 0] = 1
    gradient[0, -11:-1, 0] = -1
    gradient, dt = gradients.interpolate_gradient(gradient, 80e-3 / 99, n_t)
    return np.concatenate([gradient, 0.5 * gradient]), dt


def _icosphere(init_pos, perm_prob=0.5):
    vertices, faces = meshes.icosphere(radius=5e-6, subdivisions=1)
    return substrates.mesh(vertices, faces, periodic=True, init_pos=init_pos,
                           n_sv=np.array([2, 2, 2]), quiet=True,
                           perm_prob=perm_prob)


# (substrate factory, engine, steps): both engines, "uniform", "intra" and
# analytic seeding.
CASES = {
    "fused-uniform": (lambda: _icosphere("uniform"), "fused", 12),
    "classic-intra": (lambda: _icosphere("intra"), "classic", 12),
    "sphere": (lambda: substrates.sphere(5e-6, perm_prob=0.3), "classic", 20),
}


def _run(case, devices, **kwargs):
    make, engine, n_t = CASES[case]
    gradient, dt = _gradient(n_t)
    config.use_fused = engine == "fused"
    try:
        return simulations.simulation(
            N_SPINS, D, gradient, dt, make(), quiet=True, final_pos=True,
            exchange_stats=True, relaxation=(25e-3, 150e-3), seed=9,
            device="cpu" if devices is None else None, devices=devices,
            **kwargs)
    finally:
        config.use_fused = None


@pytest.fixture(scope="module")
def single_runs():
    return {case: _run(case, None) for case in CASES}


@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_split_equals_single_run(single_runs, case, parts):
    s1, p1, st1 = single_runs[case]
    sk, pk, stk = _run(case, ["cpu"] * parts)
    assert st1["crossings"].max() > 0
    npt.assert_array_equal(pk, p1)
    npt.assert_array_equal(stk["crossings"], st1["crossings"])
    npt.assert_array_equal(stk["intra_steps"], st1["intra_steps"])
    npt.assert_allclose(sk, s1, rtol=1e-6, atol=1e-6 * N_SPINS)


def test_split_per_spin_signals_and_trajectories(tmp_path):
    # all_signals concatenates the parts' per-spin signals in spin order;
    # a trajectory file holds every spin of every part.
    n_s, n_t = 40, 8
    gradient, dt = _gradient(n_t)
    sub = substrates.cylinder(5e-6, np.array([0.0, 1.0, 1.0]), perm_prob=0.2)
    out = {}
    for devices in (None, ["cpu"] * 3):
        traj = str(tmp_path / f"traj{devices is None}.txt")
        out[devices is None] = (simulations.simulation(
            n_s, D, gradient, dt, sub, quiet=True, all_signals=True,
            traj=traj, devices=devices,
            device="cpu" if devices is None else None), np.loadtxt(traj))
    (a1, t1), (ak, tk) = out[True], out[False]
    assert ak.shape == (2, n_s) and tk.shape == (n_t + 1, 3 * n_s)
    npt.assert_array_equal(tk, t1)
    npt.assert_allclose(ak, a1, rtol=1e-6, atol=1e-6)


def test_more_parts_than_spins():
    gradient, dt = _gradient(4)
    single = simulations.simulation(2, D, gradient, dt, substrates.free(),
                                    quiet=True, final_pos=True, device="cpu")
    split = simulations.simulation(2, D, gradient, dt, substrates.free(),
                                   quiet=True, final_pos=True,
                                   devices=["cpu"] * 3)
    npt.assert_array_equal(split[1], single[1])
    npt.assert_allclose(split[0], single[0], rtol=1e-6)


def test_device_resolution_and_ranges():
    cpu = torch.device("cpu")
    assert parallel.resolve_devices(None, "cpu") == [cpu]
    assert parallel.resolve_devices(["cpu", cpu]) == [cpu, cpu]
    assert parallel.resolve_devices("cpu", "cpu") == [cpu]
    for bad in (0, -2, True, [], ["tpu"], "nodev", [None]):
        with pytest.raises(ValueError):
            parallel.resolve_devices(bad)
    with pytest.raises(ValueError):
        parallel.resolve_devices(torch.cuda.device_count() + 1)
    assert parallel.split_ranges(10, 3) == [(0, 4), (4, 7), (7, 10)]
    assert parallel.split_ranges(2, 3) == [(0, 1), (1, 2), (2, 2)]
    spec = SphereSpec(radius=torch.tensor(2.0), perm_prob=torch.tensor(0.0))
    assert parallel.spec_to(spec, cpu) is spec


def test_a_failing_part_fails_the_run():
    def part(k):
        if k == 1:
            raise RuntimeError("part 1 failed")
        return k

    assert parallel.run_parts(part, [(0,), (2,)]) == [0, 2]
    with pytest.raises(RuntimeError, match="part 1 failed"):
        parallel.run_parts(part, [(0,), (1,), (2,)])
