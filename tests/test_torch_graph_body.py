"""The fused window's factored epoch body (engine/fused.epoch_body) on the
CPU, against the epoch loop it replaced and against the JAX package.

``run_window_fused`` now runs every epoch as one ``epoch_body`` call on an
``EpochState`` whose step scalars (RNG key, first step, valid steps, epoch
index) live in a tensor, as a CUDA graph replay needs them; on the card its
full epochs are replays of one captured body (``chip_smoke.py`` holds the
graph to the eager body bit for bit). Here the body, run epoch by epoch,
and ``run_window_fused`` must equal the earlier loop (per-step krng
directions stacked, Python-int scalars, a new phase tensor per epoch) bit
for bit, untracked and tracked, through the trailing partial epoch (10
steps at J = 4). The window is the one stored as ``window_*`` in
``tests/oracles/jax_reference_runs.npz`` (the JAX fused window in Pallas
interpret mode), held to it as ``tests/test_torch_simulation.py`` holds it,
on its first ``N_SPINS`` spins: every spin walks on its own id-keyed
streams, so a subset walks as it does in the whole ensemble.
"""

import pickle
import types

import numpy as np
import numpy.testing as npt
import pytest
import torch

from disimpy_tpu_torch import gradients, simulations, substrates
from disimpy_tpu_torch.engine import fused, fused_kernel, krng, launch_count

import torch_threads  # noqa: F401  (shares the cores among xdist workers)

D, DT = 2e-9, 1.2e-4
# The stored window ran 512 spins; these tests take the first 128.
STORED_SPINS, N_SPINS, N_STEPS, SEED = 512, 128, 10, 3
STEP_L = float(np.sqrt(6 * D * DT))


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
def window(oracles_dir, tmp_path_factory):
    """The stored window's setup: intra starts of the closed cylinder mesh,
    its pack (bitwise the JAX pack), g_eff and epsilon; the JAX outputs."""
    with open(oracles_dir / "cylinder_mesh_closed.pkl", "rb") as f:
        mesh = pickle.load(f)
    sub = substrates.mesh(mesh["vertices"], mesh["faces"], True,
                          init_pos="intra", n_sv=np.array([10, 10, 10]),
                          quiet=True)
    start = simulations._fill_mesh(STORED_SPINS, sub, True, 5, "cpu")[:N_SPINS]
    spec = fused.pack_fused(
        sub, 1 / STEP_L, n_hint=float(STORED_SPINS),
        cache_path=str(tmp_path_factory.mktemp("pack") / "cyl.pkl"))
    assert spec.resort_every == 4  # two whole epochs and a partial one
    g_eff = torch.as_tensor(
        (gradients.GAMMA * DT * STEP_L) * np.transpose(_gradient(), (1, 0, 2)),
        dtype=torch.float32)
    eps = simulations._effective_epsilon(
        1e-13, 1 / STEP_L, float(np.max(sub.voxel_size)) / STEP_L, N_STEPS,
        torch.float32, False)
    with np.load(oracles_dir / "jax_reference_runs.npz") as data:
        jax_out = {k: data["window_" + k][..., :N_SPINS]
                   for k in ("positions", "phases", "iter_exc")}
    pos0 = torch.as_tensor(start.T / STEP_L, dtype=torch.float32)
    parity = torch.from_numpy(np.random.RandomState(6).random_sample(N_SPINS)
                              < 0.5)
    return dict(spec=spec, pos0=pos0, g_eff=g_eff, eps=eps, parity=parity,
                jax=jax_out)


def _spec(window, perm):
    from dataclasses import replace

    return replace(window["spec"], perm_prob=torch.tensor(perm))


def _compartments(window):
    zeros = torch.zeros(N_SPINS, dtype=torch.int32)
    return (zeros, window["parity"], zeros)


def _earlier_loop(spec, positions, g_eff, eps, track, compartments):
    """The epoch loop ``run_window_fused`` ran before the body was
    factored: the same steps with Python-int scalars and the per-step krng
    directions."""
    J = spec.resort_every
    n, m = positions.shape[1], g_eff.shape[1]
    ids = torch.arange(n, dtype=torch.int32)
    seed_k = SEED ^ spec.seed_salt
    n_epochs = -(-N_STEPS // J)
    g_pad = torch.zeros((n_epochs * J, m, 3))
    g_pad[:N_STEPS] = g_eff
    g_flat = g_pad.reshape(n_epochs, J, m, 3).permute(0, 2, 1, 3).reshape(
        n_epochs, m, 3 * J)
    phases = torch.zeros((m, n))
    iter_exc = torch.zeros(n, dtype=torch.bool)
    for e, t_base in enumerate(range(0, N_STEPS, J)):
        n_valid = min(N_STEPS - t_base, J)
        order, shiftvox_s, inputs = fused.epoch_inputs(
            spec, positions, ids, t_base, seed_k)
        dirs = torch.stack([krng.unit_directions(seed_k, t_base + s, inputs[2])
                            for s in range(J)])
        inputs = inputs[:1] + (dirs,) + inputs[2:]
        pos_steps, exc_s, cross_s = fused_kernel.fused_epoch(
            spec, *inputs, t_base, n_valid, seed_k, eps, 1000)
        steps = torch.empty_like(pos_steps)
        steps[:, :, order] = pos_steps + shiftvox_s[None]
        exc = torch.empty_like(exc_s)
        exc[order] = exc_s
        cross = torch.empty_like(cross_s)
        cross[:, order] = cross_s
        iter_exc = iter_exc | exc
        phases = phases + g_flat[e] @ steps.reshape(3 * J, n)
        positions = steps[-1]
        if track:
            compartments = fused.fold_transits(compartments, cross, n_valid)
    return (positions, phases, iter_exc) + ((compartments,) if track else ())


def _flat(out):
    return [t for o in out for t in (o if isinstance(o, tuple) else (o,))]


def _body_by_hand(spec, window, track):
    """The body run eagerly epoch by epoch on an EpochState."""
    J = spec.resort_every
    n_epochs = -(-N_STEPS // J)
    g_pad = torch.zeros((n_epochs * J, 4, 3))
    g_pad[:N_STEPS] = window["g_eff"]
    g = g_pad.reshape(n_epochs, J, 4, 3).permute(0, 2, 1, 3).reshape(
        n_epochs, 4, 3 * J)
    phases = torch.zeros((4, N_SPINS))
    exc = torch.zeros(N_SPINS, dtype=torch.bool)
    comp = _compartments(window) if track else None
    st = fused.EpochState.like(J, window["pos0"], exc, phases, g, comp)
    st.load(window["pos0"], torch.arange(N_SPINS, dtype=torch.int32), exc,
            SEED ^ spec.seed_salt, 0, J, phases, g, comp)
    for t_base in range(0, N_STEPS, J):
        assert st.scalars.tolist() == [
            krng.int32(SEED ^ spec.seed_salt), t_base, J, t_base // J]
        n_valid = min(N_STEPS - t_base, J)
        fused._set_valid(st, n_valid, J)
        fused.epoch_body(spec, st, n_valid, window["eps"], 1000)
    return ((st.positions, st.phases, st.iter_exc)
            + ((st.compartments,) if track else ()))


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("perm", [0.0, 0.5])
def test_epoch_body_equals_the_earlier_loop(window, perm, track):
    spec = _spec(window, perm)
    comp = _compartments(window) if track else None
    want = _flat(_earlier_loop(spec, window["pos0"], window["g_eff"],
                               window["eps"], track, comp))
    by_hand = _flat(_body_by_hand(spec, window, track))
    through = _flat(fused.run_window_fused(
        spec, window["pos0"], torch.zeros((4, N_SPINS)),
        torch.zeros(N_SPINS, dtype=torch.bool), window["g_eff"],
        range(N_STEPS), SEED, window["eps"], 1000, track=track,
        compartments=comp))
    assert len(want) == len(by_hand) == len(through) == (6 if track else 3)
    for a, b, c in zip(want, by_hand, through):
        assert torch.equal(a, b) and torch.equal(a, c)
    if perm and track:
        assert int(want[3].sum()) > 0  # the permeable walls are crossed
    if not perm:
        # The stored JAX window (perm 0): as tests/test_torch_simulation.py.
        j = window["jax"]
        npt.assert_array_equal(want[2].numpy(), j["iter_exc"])
        err = np.abs(want[0].numpy() - j["positions"]).max(axis=0)
        assert np.mean(err <= 1e-4) >= 0.99, np.mean(err <= 1e-4)
        npt.assert_allclose(want[1].numpy(), j["phases"], rtol=0,
                            atol=1e-4 * np.abs(j["phases"]).max())


def test_window_leaves_its_arguments_alone(window):
    spec = _spec(window, 0.5)
    pos0 = window["pos0"].clone()
    comp = tuple(c.clone() for c in _compartments(window))
    phases = torch.zeros((4, N_SPINS))
    exc = torch.zeros(N_SPINS, dtype=torch.bool)
    fused.run_window_fused(spec, pos0, phases, exc, window["g_eff"],
                           range(N_STEPS), SEED, window["eps"], 1000,
                           track=True, compartments=comp)
    assert torch.equal(pos0, window["pos0"]) and not phases.any()
    assert not exc.any()
    for a, b in zip(comp, _compartments(window)):
        assert torch.equal(a, b)


def test_cell_keys_build_no_tensor_from_a_list(window, monkeypatch):
    spec = window["spec"]
    assert spec.n_sv_t.dtype == torch.int32
    assert spec.n_sv_t.tolist() == list(spec.n_sv)
    want = fused._cell_keys(spec, window["pos0"])

    def refuse(*args, **kwargs):
        raise AssertionError("torch.tensor called inside _cell_keys")

    monkeypatch.setattr(torch, "tensor", refuse)
    got = fused._cell_keys(spec, window["pos0"])
    for a, b in zip(want, got):
        assert torch.equal(a, b)


def test_captured_launches_count_once_per_replay(monkeypatch):
    # A launch made while the stream captures goes into the capture's
    # tally, not the counts; each replay then adds the tally.
    monkeypatch.setattr(launch_count, "counts",
                        dict.fromkeys(launch_count.KERNELS, 0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with launch_count.capture() as tally:
        launch_count.add("fused_epoch")
        launch_count.add("krng_draw")
    launch_count.add("krng_draw")  # captured with no tally open: dropped
    assert tally == {"fused_epoch": 1, "krng_draw": 1}
    assert not any(launch_count.counts.values())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    for _ in range(3):
        launch_count.replayed(tally)
    launch_count.add("mesh_hit")
    assert launch_count.counts == dict.fromkeys(launch_count.KERNELS, 0) | {
        "fused_epoch": 3, "krng_draw": 3, "mesh_hit": 1}
    launch_count.reset()
    assert not any(launch_count.counts.values())


def test_graph_cache_keeps_the_most_recent_shapes(monkeypatch):
    class Spec:
        pass

    monkeypatch.setattr(fused, "_GRAPHS", {})
    spec = Spec()

    def entry(key):
        return fused._epoch_graph(
            spec, key, lambda: types.SimpleNamespace(
                positions=torch.zeros((3, 1))))

    a = entry("a")
    assert entry("a") is a
    b = entry("b")
    entry("c")  # a is the least recent: it goes
    assert list(fused._GRAPHS[id(spec)]) == ["b", "c"]
    with b.lock:  # a shape in use stays past the limit
        entry("d")
    assert list(fused._GRAPHS[id(spec)]) == ["b", "c", "d"]
    entry("e")
    assert list(fused._GRAPHS[id(spec)]) == ["d", "e"]
    del spec
    assert not fused._GRAPHS  # the entries go with the spec
