"""The port's fused engine host half and epoch kernel against the JAX package.

- ``pack_fused`` must give bitwise the JAX pack's arrays (the NumPy code is
  the same), keep the on-disk pickle format, and ``spec_from_numpy`` must
  carry a JAX-built pack across unchanged.
- ``fused_epoch_reference`` (the CUDA kernel's plain torch version) must
  reproduce the JAX Pallas kernel, run in interpret mode on the CPU by
  ``scripts/make_torch_oracles.py`` (stored as the ``epoch_*`` arrays of
  ``tests/oracles/jax_reference_runs.npz``), on the same sorted inputs and
  the same directions: equal ``iter_exc`` and
  transit counts, and positions within 1e-5 step lengths for at least 99%
  of spins (float32 rsqrt/reciprocal may differ by an ulp between torch
  and XLA; measured on this setup: 100% within 2e-6).

The CUDA kernel itself runs only on the GPU (``chip_smoke.py``).
"""

import ctypes.util
import pickle
import shutil

import numpy as np
import numpy.testing as npt
import pytest
import torch

from disimpy_tpu import meshes as jmesh
from disimpy_tpu import substrates as jsub
from disimpy_tpu.engine import fused as jfused
from disimpy_tpu_torch import meshes, substrates
from disimpy_tpu_torch.engine import _build, fused, fused_kernel

import torch_threads  # noqa: F401  (shares the cores among xdist workers)

FIELDS = ("table", "cell_start", "cell_packed", "cell_packed2", "voxel_size",
          "sv_width", "perm_prob")
META = ("n_sv", "resort_every", "seed_salt", "eps_budget")


def _numpy_parts(spec):
    return ({k: np.asarray(getattr(spec, k)) for k in FIELDS},
            {k: getattr(spec, k) for k in META})


def _assert_same_spec(spec_t, spec_j):
    for k in FIELDS:
        npt.assert_array_equal(getattr(spec_t, k).numpy(),
                               np.asarray(getattr(spec_j, k)), err_msg=k)
    for k in META:
        assert getattr(spec_t, k) == getattr(spec_j, k), k


def _cylinder(mod, oracles_dir):
    with open(oracles_dir / "cylinder_mesh_closed.pkl", "rb") as f:
        mesh = pickle.load(f)
    return mod.mesh(mesh["vertices"], mesh["faces"], True,
                    n_sv=np.array([10, 10, 10]), quiet=True)


def _icosphere(mod, mesh_mod):
    vertices, faces = mesh_mod.icosphere(radius=5e-6, subdivisions=2)
    return mod.mesh(vertices, faces, periodic=True,
                    n_sv=np.array([4, 4, 4]), quiet=True)


# Step lengths: the icosphere setup of tests/test_fused.py, and a cylinder
# step (~1.2 um against a 5 um radius) with many bounces per step.
ICO_STEP = float(np.sqrt(6 * 2e-9 * 8e-5))
CYL_STEP = float(np.sqrt(6 * 2e-9 * 1.2e-4))


@pytest.fixture(scope="module")
def cylinder_packs(oracles_dir, tmp_path_factory):
    # Explicit cache files: other test modules pack the same geometries
    # concurrently under the default cache directory.
    tmp = tmp_path_factory.mktemp("pack")
    cache = tmp / "cyl.pkl"
    spec_j = jfused.pack_fused(_cylinder(jsub, oracles_dir), 1 / CYL_STEP,
                               cache_path=str(tmp / "cyl_jax.pkl"))
    spec_t = fused.pack_fused(_cylinder(substrates, oracles_dir),
                              1 / CYL_STEP, cache_path=str(cache))
    return spec_t, spec_j, cache


def test_pack_fused_icosphere_bitwise(tmp_path):
    spec_j = jfused.pack_fused(_icosphere(jsub, jmesh), 1 / ICO_STEP,
                               cache_path=str(tmp_path / "jax.pkl"))
    spec_t = fused.pack_fused(_icosphere(substrates, meshes), 1 / ICO_STEP,
                              cache_path=str(tmp_path / "torch.pkl"))
    _assert_same_spec(spec_t, spec_j)


def test_pack_fused_cylinder_bitwise(cylinder_packs):
    spec_t, spec_j, _ = cylinder_packs
    _assert_same_spec(spec_t, spec_j)
    assert spec_t.resort_every == 4  # the epoch kernel test needs J = 4


def test_pack_cache_format_is_the_jax_one(cylinder_packs, oracles_dir):
    spec_t, spec_j, cache = cylinder_packs
    with open(cache, "rb") as f:
        parts = pickle.load(f)
    assert set(parts) == {"arrays", "meta"}
    assert set(parts["arrays"]) == set(FIELDS)
    # The table is cached with a CH_MAX zero tail, as the JAX pack caches it.
    assert len(parts["arrays"]["table"]) == (
        len(spec_t.table) - fused.TAIL_UNITS + fused.CH_MAX)
    # The JAX package loads the port's cache file, and vice versa.
    _assert_same_spec(spec_t, jfused.pack_fused(
        _cylinder(jsub, oracles_dir), 1 / CYL_STEP, cache_path=str(cache)))
    _assert_same_spec(fused.pack_fused(
        _cylinder(substrates, oracles_dir), 1 / CYL_STEP,
        cache_path=str(cache)), spec_j)


def test_spec_from_numpy_round_trip(cylinder_packs):
    spec_t, spec_j, _ = cylinder_packs
    arrays, meta = _numpy_parts(spec_j)
    _assert_same_spec(fused.spec_from_numpy(arrays, meta, "cpu"), spec_j)
    arrays_t = {k: getattr(spec_t, k).numpy() for k in FIELDS}
    meta_t = {k: getattr(spec_t, k) for k in META}
    _assert_same_spec(fused.spec_from_numpy(arrays_t, meta_t, "cpu"), spec_j)
    with pytest.raises(ValueError):
        fused.spec_from_numpy({"table": arrays["table"]}, meta, "cpu")


@pytest.fixture(scope="module")
def epoch_case(cylinder_packs, oracles_dir):
    """1024 spins uniform in the cylinder voxel, epoch-sorted as the driver
    sorts them, with the JAX kernel's directions; both engines get the
    JAX-built table through spec_from_numpy. The JAX kernel's outputs at
    each permeability come from ``scripts/make_torch_oracles.py``
    (``epoch_*``), which ran it in interpret mode on the sorted inputs
    stored beside them; the port's ``epoch_inputs`` must rebuild those
    inputs bit for bit."""
    _, spec_j, _ = cylinder_packs
    arrays, meta = _numpy_parts(spec_j)
    n, J, seed, t_base, eps = 1024, spec_j.resort_every, 12345, 8, 1e-4
    rng = np.random.RandomState(0)
    pos = torch.from_numpy((rng.random_sample((3, n))
                            * arrays["voxel_size"][:, None]).astype(np.float32))
    spec0 = fused.spec_from_numpy(arrays, meta, "cpu")
    _, _, sorted_inputs = fused.epoch_inputs(
        spec0, pos, torch.arange(n, dtype=torch.int32), t_base, seed)
    inputs = dict(zip(("pos_s", "dirs", "ids_s", "start_s", "packed_s",
                       "packed2_s", "corner_s"), sorted_inputs))
    with np.load(oracles_dir / "jax_reference_runs.npz") as data:
        stored = {k: data[k] for k in data.files if k.startswith("epoch_")}
    for k in ("pos_s", "ids_s", "start_s", "packed_s", "packed2_s",
              "corner_s"):
        npt.assert_array_equal(inputs[k].numpy(), stored["epoch_" + k],
                               err_msg=k)
    # The JAX kernel's own directions, so both engines fold the same rays.
    assert stored["epoch_dirs"].shape == (J, 3, n)
    inputs["dirs"] = torch.from_numpy(stored["epoch_dirs"])
    jax_out = {perm: [stored[f"epoch_{k}_{tag}"]
                      for k in ("pos", "iter_exc", "cross")]
               for perm, tag in ((0.0, "p0"), (0.5, "p05"))}
    return arrays, meta, inputs, (t_base, J, seed, eps, 1000), jax_out


@pytest.mark.parametrize("perm", [0.0, 0.5])
def test_fused_epoch_reference_matches_jax_kernel(epoch_case, perm):
    arrays, meta, inputs, scalars, jax_out = epoch_case
    arrays = dict(arrays, perm_prob=np.float32(perm))
    spec = fused.spec_from_numpy(arrays, meta, "cpu")
    pos, exc, cross = fused_kernel.fused_epoch(
        spec, inputs["pos_s"], inputs["dirs"], inputs["ids_s"],
        inputs["start_s"], inputs["packed_s"], inputs["packed2_s"],
        inputs["corner_s"], *scalars,
    )
    j_pos, j_exc, j_cross = jax_out[perm]
    npt.assert_array_equal(exc.numpy(), j_exc)
    npt.assert_array_equal(cross.numpy(), j_cross)
    if perm:
        assert cross.sum() > 100  # the permeable case really crosses
    err = np.abs(pos.numpy() - j_pos).max(axis=(0, 1))
    assert np.mean(err <= 1e-5) >= 0.99, np.mean(err <= 1e-5)
    # Unit directions in, bounded motion out: no spin moves > J steps.
    moved = np.linalg.norm(pos.numpy()[-1] - inputs["pos_s"].numpy(), axis=0)
    assert moved.max() <= scalars[1] + 1e-3


def test_fused_epoch_rejects_other_devices(epoch_case):
    arrays, meta, inputs, scalars, _ = epoch_case
    spec = fused.spec_from_numpy(arrays, meta, "cpu")
    on_meta = {k: v.to("meta") for k, v in inputs.items()}
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_kernel.fused_epoch(
            spec, on_meta["pos_s"], on_meta["dirs"], on_meta["ids_s"],
            on_meta["start_s"], on_meta["packed_s"], on_meta["packed2_s"],
            on_meta["corner_s"], *scalars,
        )


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    _build.load.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("fused_epoch")


def test_existing_build_reports_its_nvcc_output(monkeypatch, tmp_path):
    # A stand-in nvcc that "builds" by copying the C math library and
    # prints a ptxas line: the second load finds the library and must
    # report the output it was built with (chip_smoke.py's phase 1 reads
    # the kernel's registers from it).
    ctypes.CDLL(ctypes.util.find_library("m"))
    with open("/proc/self/maps") as f:
        lib = next(ln.split()[-1] for ln in f if "/libm.so" in ln)
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(
        "#!/bin/sh\n"
        'while [ "$1" != "-o" ]; do shift; done\n'
        f'{shutil.which("cp")} {lib} "$2"\n'
        'echo "ptxas info    : Used 64 registers"\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", str(nvcc.parent))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    _build.load.cache_clear()
    try:
        first = _build.load("fused_epoch")
        _build.load.cache_clear()
        again = _build.load("fused_epoch")
    finally:
        _build.load.cache_clear()
    assert "Used 64 registers" in first.log and first.seconds > 0
    assert again.path == first.path and again.seconds == 0.0
    assert again.log == first.log
