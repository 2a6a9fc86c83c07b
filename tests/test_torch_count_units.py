"""The epoch kernel's counting variant, on its plain torch version, and the
driver's ``simulations._STREAM_DIAG`` (the port of the JAX package's
``engine.config.fused_count_units``).

- Counting changes no output of an epoch, a window or a run.
- The per-spin units and bounce passes and the per-warp issued units equal
  a count taken by hand from the plain version's ``_fold_units`` calls.
- A window sums its epochs' counts in int64.
- ``_STREAM_DIAG`` is reset and filled by each counted single-part fused
  run, and left as it was by classic runs, split runs and runs with
  counting off (the JAX package's rule).

The CUDA kernel's counts are held to these on the GPU (``chip_smoke.py``).
"""

import pickle

import numpy as np
import pytest
import torch

from disimpy_tpu_torch import gradients, simulations, substrates
from disimpy_tpu_torch.engine import config, fused, fused_kernel, krng

import torch_threads  # noqa: F401  (shares the cores among xdist workers)

D = 2e-9
# The epoch setup of tests/test_torch_fused.py (~1.2 um steps against the
# 5 um closed cylinder), with the port's own directions.
CYL_STEP = float(np.sqrt(6 * D * 1.2e-4))
N, SEED, T_BASE, EPS = 1024, 12345, 8, 1e-4
# A step duration no other test packs the cylinder at: simulation() uses
# the default disk cache, which other test modules may write concurrently.
RUN_DT = 1.1e-4


def _cylinder(oracles_dir, **kw):
    with open(oracles_dir / "cylinder_mesh_closed.pkl", "rb") as f:
        mesh = pickle.load(f)
    return substrates.mesh(mesh["vertices"], mesh["faces"], True,
                           n_sv=np.array([10, 10, 10]), quiet=True, **kw)


@pytest.fixture(scope="module")
def epoch_case(oracles_dir, tmp_path_factory):
    """1024 spins uniform in the cylinder voxel, epoch-sorted as the driver
    sorts them (the setup of test_torch_fused.py's epoch_case)."""
    spec = fused.pack_fused(
        _cylinder(oracles_dir), 1 / CYL_STEP,
        cache_path=str(tmp_path_factory.mktemp("pack") / "cyl.pkl"))
    rng = np.random.RandomState(0)
    pos = torch.from_numpy((rng.random_sample((3, N))
                            * spec.voxel_size.numpy()[:, None])
                           .astype(np.float32))
    _, _, inputs = fused.epoch_inputs(
        spec, pos, torch.arange(N, dtype=torch.int32), T_BASE, SEED)
    return spec, inputs, (T_BASE, spec.resort_every, SEED, EPS, 1000)


def _with_perm(spec, perm):
    from dataclasses import replace

    return replace(spec, perm_prob=torch.tensor(perm))


@pytest.mark.parametrize("perm", [0.0, 0.5])
def test_counting_changes_no_output(epoch_case, perm):
    spec, inputs, scalars = epoch_case
    spec = _with_perm(spec, perm)
    plain = fused_kernel.fused_epoch(spec, *inputs, *scalars)
    counted = fused_kernel.fused_epoch(spec, *inputs, *scalars, count=True)
    assert len(plain) == 3 and len(counted) == 4
    for a, b in zip(plain, counted):
        assert torch.equal(a, b)
    units, passes, issued = counted[3]
    for c, size in ((units, N), (passes, N),
                    (issued, -(-N // fused_kernel.SPINS_PER_WARP))):
        assert c.dtype == torch.int32 and c.shape == (size,)


@pytest.mark.parametrize("perm", [0.0, 0.5])
def test_counts_equal_a_hand_count_of_the_folds(epoch_case, monkeypatch,
                                                perm):
    spec, inputs, scalars = epoch_case
    spec = _with_perm(spec, perm)
    ids_s = inputs[2]
    # Each bounce pass folds, then draws its permeability uniforms for the
    # same spins: pair the fold's prefix counts with the draw's spin ids.
    fold, draw = fused_kernel._fold_units, krng.bounce_uniform
    folds, passes_seen = [], []

    def fold_rec(table, start, cnt, *rest):
        folds.append(cnt.clone())
        return fold(table, start, cnt, *rest)

    def draw_rec(seed, t, ids, it):
        passes_seen.append((ids.clone(), folds.pop()))
        return draw(seed, t, ids, it)

    monkeypatch.setattr(fused_kernel, "_fold_units", fold_rec)
    monkeypatch.setattr(krng, "bounce_uniform", draw_rec)
    units, passes, issued = fused_kernel.fused_epoch(
        spec, *inputs, *scalars, count=True)[3]

    slot = torch.empty(N, dtype=torch.long)
    slot[ids_s.long()] = torch.arange(N)  # spin id -> sorted position
    w = fused_kernel.SPINS_PER_WARP
    want_units = np.zeros(N, np.int64)
    want_passes = np.zeros(N, np.int64)
    want_issued = np.zeros(-(-N // w), np.int64)
    for ids, cnt in passes_seen:
        where = slot[ids.long()].numpy()
        np.add.at(want_units, where, cnt.numpy())
        np.add.at(want_passes, where, 1)
        most = np.zeros_like(want_issued)
        np.maximum.at(most, where // w, cnt.numpy())
        want_issued += w * most
    np.testing.assert_array_equal(units.numpy(), want_units)
    np.testing.assert_array_equal(passes.numpy(), want_passes)
    np.testing.assert_array_equal(issued.numpy(), want_issued)
    assert want_passes.min() >= scalars[1]  # one pass per step at least
    assert 0 < want_units.sum() <= want_issued.sum()


def test_window_sums_epoch_counts_in_int64(epoch_case):
    spec, _, _ = epoch_case
    n, n_t = 256, 10  # two whole epochs and a partial one
    rng = np.random.RandomState(1)
    pos = torch.from_numpy((rng.random_sample((3, n))
                            * spec.voxel_size.numpy()[:, None])
                           .astype(np.float32))
    ids = torch.arange(n, dtype=torch.int32)
    seed_k = SEED ^ spec.seed_salt
    per_epoch = [out[-1] for out in fused.epochs(
        spec, pos, ids, 0, n_t, seed_k, EPS, 1000, count=True)]
    assert len(per_epoch) == 3
    g = torch.from_numpy(rng.normal(size=(n_t, 2, 3)).astype(np.float32))
    args = (spec, pos, torch.zeros((2, n)), torch.zeros(n, dtype=torch.bool),
            g, range(n_t), SEED, EPS, 1000)
    plain = fused.run_window_fused(*args)
    counted = fused.run_window_fused(*args, count=True)
    for a, b in zip(plain, counted):
        assert torch.equal(a, b)
    total = counted[-1]
    assert total.dtype == torch.int64 and total.shape == (3,)
    assert torch.equal(total, sum(per_epoch))


def _run(sub, n, devices=None, seed=4):
    bs = np.linspace(1, 3e9, 2)
    gradient = np.zeros((1, 8, 3))
    gradient[0, 1:3, 0], gradient[0, 5:7, 0] = 1, -1
    gradient = gradients.set_b(np.concatenate([gradient] * 2), RUN_DT, bs)
    return simulations.simulation(
        n, D, gradient, RUN_DT, sub, seed=seed, quiet=True, final_pos=True,
        devices=devices, device=None if devices else "cpu")


def test_stream_diag_life_cycle(oracles_dir, monkeypatch):
    sub = _cylinder(oracles_dir)
    n = 256
    sentinel = [-1, -2, -3]
    monkeypatch.setattr(simulations, "_STREAM_DIAG", list(sentinel))
    # Counting off: untouched.
    plain = _run(sub, n)
    assert simulations._STREAM_DIAG == sentinel
    monkeypatch.setattr(config, "fused_count_units", True)
    counted = _run(sub, n)
    for a, b in zip(plain, counted):
        np.testing.assert_array_equal(a, b)
    diag = list(simulations._STREAM_DIAG)
    units, passes, issued = diag
    assert all(isinstance(x, int) for x in diag)
    assert 0 < units / issued <= 1
    assert passes >= n * 8  # at least one pass per spin-step
    # Reset per counted run, not added up.
    _run(sub, n)
    assert simulations._STREAM_DIAG == diag
    simulations._STREAM_DIAG[:] = sentinel
    # A split run, a classic run: untouched.
    split = _run(sub, n, devices=["cpu", "cpu"])
    for a, b in zip(plain, split):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * n)
    monkeypatch.setattr(config, "use_fused", False)
    _run(sub, 64)
    assert simulations._STREAM_DIAG == sentinel
