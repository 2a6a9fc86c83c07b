"""The reference against the program's CPU path at a tiny size, and the
comparison failing each fault the cells can have."""

import numpy as np
import pytest
import torch

import faults
import run
from harness import meshfile, stats, waveforms
from reference import walk
from tiny import TINY

CELLS = ("cylinder.fused", "cylinder.classic-f64")


def _tiny_inputs():
    traffic = dict(run.bench_manifest.read_json("traffic", "fused.json"),
                   n_t=30)
    v, f, kwargs = meshfile.build({"mesh_file": "cylinder_mesh.npz",
                                   "periodic": True}, 0)
    return traffic, v, f, waveforms.make(traffic)


@pytest.mark.parametrize("dtype,engine", [("float64", "classic"),
                                          ("float32", "fused")])
def test_reference_agrees_with_the_cpu_path(fresh_home, dtype, engine):
    from disimpy_tpu_torch import simulations, substrates

    traffic, v, f, g = _tiny_inputs()
    n = 1024
    padding = np.array([1e-6, 1e-6, 0.0])
    start = np.zeros((n, 3)) + np.array([6e-6, 6e-6, 12.5e-6])
    for init_pos in ("uniform", start):
        sub = substrates.mesh(v, f, periodic=True, quiet=True,
                              padding=padding, init_pos=init_pos,
                              n_sv=np.array([5, 5, 5]))
        for seed in (3, 2**31 + 12345):
            signal, positions = simulations.simulation(
                n, traffic["diffusivity"], g, traffic["dt"], sub, seed=seed,
                quiet=True, dtype=dtype, device="cpu", final_pos=True)
            ref = walk.simulate(v, f, n, traffic["diffusivity"], g,
                                traffic["dt"], seed, init_pos, engine,
                                getattr(torch, dtype), padding=padding)
            limit = 1e-15 if dtype == "float64" else 1e-6
            assert stats.signal_gap(signal, ref.signal, n) < limit
            assert stats.compared(signal, positions, ref, n)[
                "position_share"] == 0.0


def test_precision_below_fails_the_float64_comparison():
    traffic, v, f, g = _tiny_inputs()
    n, seed = 1024, 11
    args = (v, f, n, traffic["diffusivity"], g, traffic["dt"], seed,
            "uniform", "classic", torch.float64)
    ref = walk.simulate(*args)
    low = walk.simulate(*args, dtype=torch.float32)
    assert stats.signal_gap(low.signal, ref.signal, n) > 1e-3


def test_position_share_takes_the_nearest_image():
    voxel, step = np.array([10.0, 10.0, 20.0]), 0.5
    ref = np.array([[1.0, 1.0, 1.0], [9.9, 5.0, 5.0], [5.0, 5.0, 5.0]])
    moved = ref + np.array([[10.0, -20.0, 40.0], [0.001, 0, 0], [0.2, 0, 0]])
    assert stats.position_share(moved, ref, voxel, step, 0.01) == \
        pytest.approx(1 / 3)
    assert stats.position_share(moved[:2], ref, voxel, step, 0.01) == 1.0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None, *faults.FAULTS],
                         ids=["sound", *faults.FAULTS])
def test_each_fault_reads_incorrect(fresh_home, cell, fault):
    result = run.run(cell, 2**31 + 99, 0.1, False, device="cpu",
                     overrides=TINY, program=faults.FAULTS.get(fault))
    assert result["correct"] is (fault is None)
    assert list(result)[-1] == "checks"
