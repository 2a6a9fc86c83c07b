"""Non-periodic meshes through the port against the JAX package, and the
port's parity runner ``scripts/parity_torch.py``.

- The non-periodic closed cylinder with 2 um of padding (the
  ``mesh_misst_p0_pad1`` cell of ``PARITY_r05.json``), at the MISST step
  length: the fused pack bitwise equal to the JAX pack, the "intra" starts
  equal to the JAX ``_fill_mesh``'s (all but at most 1e-4 of them), the
  first epoch's anchor-sorted spin ids equal, and the fused window (the
  kernel's plain version) against the JAX fused window in Pallas interpret
  mode over 8 steps: iter_exc equal, positions within 1e-5 step lengths for
  at least 99% of the spins, phases to float32 resolution.
- The neuron mesh's start classifier (non-periodic: the 12 voxel-wall
  triangles left out) against the JAX package's on 1,024 points near the
  surface.
- ``parity_torch.matrix()`` is exactly PARITY_r05's keys and thresholds;
  the runner records engines and times, fails without a GPU unless asked
  for the CPU, and runs its mesh group at a tiny size on the CPU.

The JAX outputs come from ``scripts/make_torch_oracles.py``
(``tests/oracles/jax_reference_runs.npz``, keys ``nonperiodic_*`` and
``neuron_*``), so no test here compiles JAX.
"""

import importlib.util
import json
import pickle

import numpy as np
import numpy.testing as npt
import pytest
import torch

from disimpy_tpu import substrates as jsub
from disimpy_tpu.engine import fused as jfused
from disimpy_tpu_torch import simulations, substrates
from disimpy_tpu_torch.engine import fused

import torch_threads  # noqa: F401  (shares the cores among xdist workers)

D = 2e-9
# The setup of scripts/make_torch_oracles.py's nonperiodic_run.
NP_SPINS, NP_STEPS, NP_SEED = 512, 8, 123
NP_DT = 70e-3 / 999
STEP = float(np.sqrt(6 * D * NP_DT))
FIELDS = ("table", "cell_start", "cell_packed", "cell_packed2", "voxel_size",
          "sv_width", "perm_prob")
META = ("n_sv", "resort_every", "seed_salt", "eps_budget")


@pytest.fixture(scope="module")
def oracle(oracles_dir):
    with np.load(oracles_dir / "jax_reference_runs.npz") as f:
        return {k: f[k] for k in f.files
                if k.startswith(("nonperiodic_", "neuron_"))}


def _padded_cylinder(mod, oracles_dir):
    with open(oracles_dir / "cylinder_mesh_closed.pkl", "rb") as f:
        mesh = pickle.load(f)
    return mod.mesh(mesh["vertices"], mesh["faces"], False,
                    padding=np.full(3, 2e-6), init_pos="intra",
                    n_sv=np.array([10, 10, 10]), quiet=True)


@pytest.fixture(scope="module")
def packs(oracles_dir, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pack")
    spec_j = jfused.pack_fused(_padded_cylinder(jsub, oracles_dir), 1 / STEP,
                               n_hint=float(NP_SPINS),
                               cache_path=str(tmp / "jax.pkl"))
    sub = _padded_cylinder(substrates, oracles_dir)
    spec_t = fused.pack_fused(sub, 1 / STEP, n_hint=float(NP_SPINS),
                              cache_path=str(tmp / "torch.pkl"))
    return spec_t, spec_j, sub


def test_nonperiodic_pack_equals_jax(packs):
    spec_t, spec_j, sub = packs
    for k in FIELDS:
        npt.assert_array_equal(getattr(spec_t, k).numpy(),
                               np.asarray(getattr(spec_j, k)), err_msg=k)
    for k in META:
        assert getattr(spec_t, k) == getattr(spec_j, k), k
    # The padded mesh sits inside a larger voxel whose walls are 12 more
    # triangles; the pack serves their cells too.
    assert len(sub.faces) == 12 + len(np.asarray(sub.faces[:-12]))
    assert np.all(np.asarray(sub.vertices)[:-8].min(axis=0) >= 2e-6 - 1e-12)


def test_nonperiodic_intra_starts_equal_jax(packs, oracle):
    _, _, sub = packs
    starts = simulations._fill_mesh(NP_SPINS, sub, True, NP_SEED, "cpu")
    differ = ~np.all(starts == oracle["nonperiodic_starts"], axis=1)
    assert differ.sum() <= 1e-4 * NP_SPINS, differ.sum()


def test_nonperiodic_window_matches_jax(packs, oracle):
    spec, _, sub = packs
    starts = oracle["nonperiodic_starts"]
    pos = torch.as_tensor(starts.T * (1.0 / STEP), dtype=torch.float32)
    ids = torch.arange(NP_SPINS, dtype=torch.int32)
    _, _, inputs = fused.epoch_inputs(spec, pos, ids, 0,
                                      NP_SEED ^ spec.seed_salt)
    npt.assert_array_equal(inputs[2].numpy(), oracle["nonperiodic_ids"])
    eps = simulations._effective_epsilon(
        1e-13, 1 / STEP, float(np.max(sub.voxel_size)) / STEP, NP_STEPS,
        torch.float32, True)
    assert eps == float(oracle["nonperiodic_eps"])
    g_eff = oracle["nonperiodic_g_eff"]
    positions, phases, iter_exc = fused.run_window_fused(
        spec, pos, torch.zeros((g_eff.shape[1], NP_SPINS)),
        torch.zeros(NP_SPINS, dtype=torch.bool), torch.from_numpy(g_eff),
        range(NP_STEPS), NP_SEED, eps, 1000)
    npt.assert_array_equal(iter_exc.numpy(), oracle["nonperiodic_iter_exc"])
    err = np.abs(positions.numpy() - oracle["nonperiodic_pos"]).max(axis=0)
    assert np.mean(err <= 1e-5) >= 0.99, np.mean(err <= 1e-5)
    ref = oracle["nonperiodic_phases"]
    npt.assert_allclose(phases.numpy(), ref, rtol=0,
                        atol=1e-4 * np.abs(ref).max())
    # Inside the voxel, and the spins really bounced off the cylinder.
    vox = spec.voxel_size.numpy()[:, None]
    assert np.all((positions.numpy() >= 0) & (positions.numpy() <= vox))


def test_neuron_classifier_equals_jax(oracles_dir, oracle):
    with open(oracles_dir / "neuron-model.pkl", "rb") as f:
        mesh = pickle.load(f)
    sub = substrates.mesh(mesh["vertices"], mesh["faces"], False,
                          n_sv=np.array([20, 20, 20]), quiet=True)
    inside = simulations._make_intra_classifier(sub, "cpu")(
        oracle["neuron_points"])
    npt.assert_array_equal(inside, oracle["neuron_inside"])
    assert 0 < inside.sum() < len(inside)


def _parity_torch():
    path = __import__("pathlib").Path(__file__).parents[1] / "scripts" / (
        "parity_torch.py")
    spec = importlib.util.spec_from_file_location("parity_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_parity_matrix_is_parity_r05(oracles_dir):
    with open(oracles_dir.parent.parent / "PARITY_r05.json") as f:
        ref = json.load(f)
    want = [(k, v["threshold"]) for k, v in ref.items()
            if not k.startswith("_")]
    assert _parity_torch().matrix() == want
    assert len(want) == 37


def test_parity_runner_has_no_cpu_fallback(monkeypatch):
    parity_torch = _parity_torch()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA GPU"):
        parity_torch.Parity("cuda")


def test_parity_runner_mesh_group_on_cpu(tmp_path):
    parity_torch = _parity_torch()
    out = tmp_path / "parity.json"
    parity = parity_torch.Parity("cpu", spins=1e-3, steps=0.1, out=str(out),
                                 quiet=True)
    n_svs = ((1, 1, 1), (10, 10, 10))
    runs = parity.mesh(periodic=(False,), padding=(1,), n_svs=n_svs)
    assert parity.finish(commit="test") in (True, False)
    written = json.loads(out.read_text())
    keys = [parity_torch.mesh_key(False, 1, v) for v in n_svs]
    assert set(written) == {*keys, *(k + "_leak" for k in keys), "_meta"}
    for k in keys:
        assert written[k]["engine"] == "fused"
        assert written[k]["wall_s"] > 0 and written[k]["fused_pack_s"] >= 0
        assert np.all(np.isfinite(runs[k][0]))
    meta = written["_meta"]
    assert meta["nsv_signal_max_abs_diff"] == {"p0_pad1": 0.0}
    assert meta["commit"] == "test" and meta["device"] == "cpu"
