"""The fused engine's two knobs, ``config.fused_resort_every`` (the epoch
length J) and ``config.fused_cell_steps`` (a fixed cell width), against the
JAX package, on the CPU.

- The spec that ``simulation()`` builds under each knob value
  (``simulations._fused_spec``) is bitwise the JAX package's
  ``pack_fused(resort_every=J)`` or ``pack_fused(cell_steps=w)``: every
  array and every meta field, on the periodic closed cylinder and the
  icosphere of ``tests/test_torch_fused.py``.
- Both knobs key the substrate's spec cache: flipping one between two
  ``simulation()`` calls builds a new spec, and flipping it back serves the
  first spec again. A J outside 1..MAX_J raises ``pack_fused``'s
  ValueError.
- Whole fused runs at J = 2 and at width 2.0 through the kernel's plain
  version, against the JAX package's fused ``simulation()`` under the same
  knob in Pallas interpret mode (``knob_*`` of
  ``tests/oracles/jax_reference_runs.npz``, written by
  ``scripts/make_torch_oracles.py``). The setup and tolerances are those
  of ``tests/test_torch_simulation.py``: signals within 1e-5 per spin, and
  positions within 1e-4 step lengths for at least 99% of the spins (float32
  cos/sin of the directions differ by ~1 ulp between torch and XLA, so at
  most 1% of the spins may diverge at a grazing bounce).
"""

import pickle

import numpy as np
import numpy.testing as npt
import pytest

from disimpy_tpu import meshes as jmesh
from disimpy_tpu import substrates as jsub
from disimpy_tpu.engine import fused as jfused
from disimpy_tpu_torch import gradients, meshes, simulations, substrates
from disimpy_tpu_torch.engine import config, fused

import torch_threads  # noqa: F401  (shares the cores among xdist workers)

FIELDS = ("table", "cell_start", "cell_packed", "cell_packed2", "voxel_size",
          "sv_width", "perm_prob")
META = ("n_sv", "resort_every", "seed_salt", "eps_budget")
D = 2e-9
# The fused run of tests/test_torch_simulation.py.
N_SPINS, N_STEPS, SEED, DT = 512, 10, 3, 1.2e-4
# Step lengths of the pack setups (tests/test_torch_fused.py).
ICO_STEP = float(np.sqrt(6 * D * 8e-5))
CYL_STEP = float(np.sqrt(6 * D * 1.2e-4))
# Knob values: (config.fused_resort_every, config.fused_cell_steps).
PACK_KNOBS = {"J1": (1, None), "J2": (2, None), "J3": (3, None),
              "J5": (5, None), "w2.0": (4, 2.0)}
RUN_KNOBS = {"J2": (2, None), "w2": (4, 2.0)}


def _closed_cylinder(mod, oracles_dir, **kw):
    with open(oracles_dir / "cylinder_mesh_closed.pkl", "rb") as f:
        mesh = pickle.load(f)
    return mod.mesh(mesh["vertices"], mesh["faces"], True,
                    n_sv=np.array([10, 10, 10]), quiet=True, **kw)


def _icosphere(mod, mesh_mod):
    vertices, faces = mesh_mod.icosphere(radius=5e-6, subdivisions=2)
    return mod.mesh(vertices, faces, periodic=True,
                    n_sv=np.array([4, 4, 4]), quiet=True)


def _assert_same_spec(spec_t, spec_j):
    for k in FIELDS:
        npt.assert_array_equal(getattr(spec_t, k).numpy(),
                               np.asarray(getattr(spec_j, k)), err_msg=k)
    for k in META:
        assert getattr(spec_t, k) == getattr(spec_j, k), k


@pytest.fixture
def knobs(monkeypatch, tmp_path):
    """Sets the two knobs for one test (restored after it), with the pack's
    disk cache in a directory of the test's own."""
    monkeypatch.setenv("HOME", str(tmp_path))

    def set_knobs(J, width):
        monkeypatch.setattr(config, "fused_resort_every", J)
        monkeypatch.setattr(config, "fused_cell_steps", width)

    return set_knobs


@pytest.mark.parametrize("knob", list(PACK_KNOBS))
def test_knob_pack_equals_jax(knob, knobs, oracles_dir, tmp_path):
    J, width = PACK_KNOBS[knob]
    knobs(J, width)
    for name, sub_t, sub_j, step in (
        ("cylinder", _closed_cylinder(substrates, oracles_dir),
         _closed_cylinder(jsub, oracles_dir), CYL_STEP),
        ("icosphere", _icosphere(substrates, meshes), _icosphere(jsub, jmesh),
         ICO_STEP),
    ):
        spec_t = simulations._fused_spec(sub_t, N_SPINS, 1 / step, "cpu")
        spec_j = jfused.pack_fused(
            sub_j, 1 / step, resort_every=J, cell_steps=width,
            n_hint=float(N_SPINS), cache_path=str(tmp_path / f"{name}.pkl"))
        _assert_same_spec(spec_t, spec_j)
        # These small geometries take every J asked for; a fixed width sets
        # the grid the search would not choose.
        assert spec_t.resort_every == J, name
        default = jfused.pack_fused(
            sub_j, 1 / step, n_hint=float(N_SPINS),
            cache_path=str(tmp_path / f"{name}_default.pkl"))
        if width is not None:
            assert spec_t.n_sv != default.n_sv, name
            voxel = np.asarray(sub_t.voxel_size) / step
            assert spec_t.n_sv == tuple(np.floor(voxel / width).astype(int))


@pytest.mark.parametrize("J", [0, fused.MAX_J + 1])
def test_out_of_range_epoch_length_raises(J, knobs, oracles_dir):
    knobs(J, None)
    with pytest.raises(ValueError, match=r"resort_every must be in \[1, 5\]"):
        simulations.simulation(
            8, D, np.zeros((1, 2, 3)), DT,
            _closed_cylinder(substrates, oracles_dir), quiet=True,
            device="cpu")


def test_knobs_key_the_spec_cache(knobs, oracles_dir, monkeypatch):
    packs, used = [], []
    pack, fused_spec = fused.pack_fused, simulations._fused_spec

    def counted_pack(*args, **kwargs):
        packs.append((kwargs["resort_every"], kwargs["cell_steps"]))
        return pack(*args, **kwargs)

    def recorded_spec(*args):
        used.append(fused_spec(*args))
        return used[-1]

    monkeypatch.setattr(fused, "pack_fused", counted_pack)
    monkeypatch.setattr(simulations, "_fused_spec", recorded_spec)
    sub = _closed_cylinder(substrates, oracles_dir)

    def run(J, width):
        knobs(J, width)
        simulations.simulation(16, D, np.zeros((1, 2, 3)), DT, sub,
                               quiet=True, device="cpu")
        return used[-1]

    first = run(4, None)
    for J, width in ((2, None), (4, 2.0)):
        other = run(J, width)
        assert other is not first
        assert (other.resort_every, other.n_sv) != (first.resort_every,
                                                    first.n_sv)
        assert run(4, None) is first
        assert run(J, width) is other
    assert packs == [(4, None), (2, None), (4, 2.0)]


def _gradient():
    bs = np.linspace(1, 3e9, 4)
    gradient = np.zeros((1, 700, 3))
    gradient[0, 1:300, 0] = 1
    gradient[0, -300:-1, 0] = -1
    gradient = np.concatenate([gradient for _ in bs], axis=0)
    gradient, _ = gradients.interpolate_gradient(gradient, 70e-3 / 699,
                                                 N_STEPS)
    return gradients.set_b(gradient, DT, bs)


@pytest.fixture(scope="module")
def intra_points(oracles_dir):
    sub = _closed_cylinder(substrates, oracles_dir, init_pos="intra")
    return simulations._fill_mesh(N_SPINS, sub, True, 5, "cpu")


@pytest.mark.parametrize("perm", [0.0, 0.5])
@pytest.mark.parametrize("knob", list(RUN_KNOBS))
def test_simulation_under_knob_matches_jax(knob, perm, knobs, intra_points,
                                           oracles_dir):
    J, width = RUN_KNOBS[knob]
    knobs(J, width)
    sub = _closed_cylinder(substrates, oracles_dir, init_pos=intra_points,
                           perm_prob=perm)
    signals, pos = simulations.simulation(
        N_SPINS, D, _gradient(), DT, sub, seed=SEED, final_pos=True,
        quiet=True, device="cpu",
    )
    (spec,) = [v for k, v in sub._accel_cache.items() if k[0] == "fused-torch"]
    assert spec.resort_every == J
    step_l = np.sqrt(6 * D * DT)
    if width is not None:
        voxel = np.asarray(sub.voxel_size) / step_l
        assert spec.n_sv == tuple(np.floor(voxel / width).astype(int))
    tag = "p0" if perm == 0 else "p05"
    with np.load(oracles_dir / "jax_reference_runs.npz") as data:
        ref_signals = data[f"knob_{knob}_signals_{tag}"]
        ref_pos = data[f"knob_{knob}_pos_{tag}"]
    npt.assert_allclose(signals / N_SPINS, ref_signals / N_SPINS, rtol=0,
                        atol=1e-5)
    err = np.abs(pos - ref_pos).max(axis=1) / step_l
    assert np.mean(err <= 1e-4) >= 0.99, np.mean(err <= 1e-4)
    if not perm:
        # Confinement: the impermeable closed cylinder keeps every spin in.
        c = np.asarray(sub.voxel_size) / 2
        r = np.linalg.norm((pos - c)[:, :2], axis=1)
        assert r.max() < 5e-6 * (1 + 1e-3)
