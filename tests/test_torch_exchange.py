"""Exchange statistics and T2 relaxation in the port, on the CPU.

The port of ``tests/test_exchange.py`` and of the tracking tests of
``tests/test_permeability.py``, at their sizes, on ``device="cpu"``. The
mesh cases run on both engines: the classic one (what the JAX package runs
on the CPU) and the fused one (its kernel's plain version). They pin:

- uniform (scalar) T2 is an exact global ``exp(-T / T2)`` factor;
- impermeable runs report zero transits and pure-intra dwell;
- the relaxation-weighted signal equals the weight sum the reported dwell
  steps imply (same walks, b = 0);
- the tracked parity agrees with a geometric reclassification of the final
  positions;
- the fused tracked run equals the JAX package's per spin: the two share
  the kernel's streams (JAX: ``simulation`` with the fused engine in Pallas
  interpret mode, stored by ``scripts/make_torch_oracles.py`` as the
  ``fused_*`` arrays of ``tests/oracles/jax_reference_runs.npz``);
- the classic engine cannot share JAX's draws, so on the permeable analytic
  sphere its mean crossings and intra fraction are held to the JAX
  package's (``sphere_*`` arrays, from ``simulation`` on
  ``substrates.sphere(5e-6, perm_prob=0.5)``) within 4 standard errors,
  with the JAX engine's draw correlation fed in (see
  :func:`test_classic_sphere_stats_match_jax`).
"""

import pickle

import numpy as np
import numpy.testing as npt
import pytest
import torch

from disimpy_tpu_torch import gradients, meshes, simulations, substrates
from disimpy_tpu_torch.engine import config, core, krng, rng, stepping
from disimpy_tpu_torch.engine.specs import SphereSpec

import torch_threads  # noqa: F401  (shares the cores among xdist workers)

D = 2e-9
RADIUS = 5e-6
T2I, T2E = 25e-3, 150e-3


@pytest.fixture(params=["classic", "fused"])
def engine(request):
    config.use_fused = request.param == "fused"
    try:
        yield request.param
    finally:
        config.use_fused = None


@pytest.fixture(scope="module")
def jax_runs(oracles_dir):
    with np.load(oracles_dir / "jax_reference_runs.npz") as data:
        return dict(data)


def _sphere_substrate(perm_prob, init_pos="intra"):
    vertices, faces = meshes.icosphere(radius=RADIUS, subdivisions=2)
    return substrates.mesh(
        vertices, faces, periodic=True, init_pos=init_pos,
        n_sv=np.array([4, 4, 4]), quiet=True, perm_prob=perm_prob,
    )


def _weights(intra_steps, n_t, dt, t2i=T2I, t2e=T2E):
    k = intra_steps.astype(float)
    return np.exp(-(dt / t2i) * k - (dt / t2e) * (n_t - k))


def _run(*args, **kwargs):
    return simulations.simulation(*args, quiet=True, device="cpu", **kwargs)


def test_uniform_t2_scales_signal():
    n_s, n_t = 400, 60
    gradient = np.ones((2, n_t, 3)) * 1e-3
    dt = 2e-4
    t2 = 80e-3
    base = _run(n_s, D, gradient, dt, substrates.free())
    weighted = _run(n_s, D, gradient, dt, substrates.free(), relaxation=t2)
    npt.assert_allclose(weighted, base * np.exp(-n_t * dt / t2), rtol=1e-6)


def test_impermeable_no_transits_and_pure_intra_weight(engine):
    n_s, n_t = 300, 50
    dt = 2e-4
    t2_intra, t2_extra = 30e-3, 200e-3
    signals, stats = _run(
        n_s, D, np.zeros((1, n_t, 3)), dt, _sphere_substrate(0.0),
        relaxation=(t2_intra, t2_extra), exchange_stats=True,
    )
    npt.assert_array_equal(stats["crossings"], 0)
    npt.assert_array_equal(stats["intra_steps"], n_t)
    npt.assert_array_equal(stats["intra_fraction"], 1.0)
    # b = 0: every phase is 0, so the signal is exactly the weight sum.
    npt.assert_allclose(
        signals[0], n_s * np.exp(-n_t * dt / t2_intra), rtol=1e-5
    )


def test_permeable_weight_consistent_with_dwell(engine):
    n_s, n_t = 400, 80
    dt = 2e-4
    signals, stats = _run(
        n_s, D, np.zeros((1, n_t, 3)), dt, _sphere_substrate(0.5), seed=11,
        relaxation=(T2I, T2E), exchange_stats=True,
    )
    assert stats["crossings"].max() > 0  # membrane is actually permeable
    assert 0.0 < stats["intra_fraction"].mean() < 1.0
    # Exact consistency: with b = 0 the signal equals the sum of the
    # weights implied by the reported dwell steps.
    npt.assert_allclose(signals[0], _weights(stats["intra_steps"], n_t,
                                             dt).sum(), rtol=1e-5)


def test_tracked_parity_matches_final_geometry(engine):
    n_s, n_t = 300, 60
    substrate = _sphere_substrate(0.5)
    _, pos, stats = _run(
        n_s, D, np.zeros((1, n_t, 3)), 2e-4, substrate, seed=5,
        final_pos=True, exchange_stats=True,
    )
    # Wrap the (periodic, unwrapped) final positions into the home voxel
    # and reclassify: inside <=> started intra and made an even number of
    # transits.
    voxel = np.asarray(substrate.voxel_size)
    wrapped = pos - np.floor(pos / voxel) * voxel
    inside = simulations._make_intra_classifier(substrate, "cpu")(wrapped)
    expected = (stats["crossings"] % 2) == 0  # started intra
    assert stats["crossings"].max() > 0
    # Epsilon surface offsets can leave a spin ambiguously close to the
    # membrane; allow a tiny disagreement rate.
    assert float((inside != expected).mean()) < 0.01


def test_uniform_seeding_parity_from_geometry(engine):
    # "uniform" starts are classified by ray parity: with an impermeable
    # membrane each spin dwells every step or none inside, as it started.
    n_s, n_t = 200, 12
    substrate = _sphere_substrate(0.0, init_pos="uniform")
    _, pos, stats = _run(n_s, D, np.zeros((1, n_t, 3)), 2e-4, substrate,
                         seed=4, final_pos=True, exchange_stats=True)
    voxel = np.asarray(substrate.voxel_size)
    inside = simulations._make_intra_classifier(substrate, "cpu")(
        pos - np.floor(pos / voxel) * voxel)
    assert 0 < inside.sum() < n_s
    npt.assert_array_equal(stats["crossings"], 0)
    npt.assert_array_equal(stats["intra_steps"], np.where(inside, n_t, 0))


def test_exchange_stats_free_substrate_zeros():
    n_s, n_t = 100, 20
    signals, stats = _run(n_s, D, np.zeros((1, n_t, 3)), 1e-4,
                          substrates.free(), exchange_stats=True)
    npt.assert_array_equal(stats["crossings"], 0)
    npt.assert_array_equal(stats["intra_steps"], 0)
    npt.assert_array_equal(signals, n_s)


def test_relaxation_validation():
    gradient = np.zeros((1, 10, 3))
    for bad in (
        dict(relaxation=(30e-3, 100e-3)),  # a pair needs a surface
        dict(relaxation=-1.0),
        dict(relaxation=(1.0, 2.0, 3.0)),
        dict(exchange_stats="yes"),
    ):
        with pytest.raises(ValueError):
            _run(10, D, gradient, 1e-4, substrates.free(), **bad)


def test_analytic_exchange_stats_and_two_compartment_relaxation():
    n_s, n_t = 1200, 60
    gradient = np.zeros((1, n_t, 3))
    dt = 2e-4
    substrate = substrates.sphere(RADIUS, perm_prob=0.5)
    _, pos, stats = _run(n_s, D, gradient, dt, substrate, seed=5,
                         final_pos=True, exchange_stats=True)
    assert stats["crossings"].sum() > 0
    assert 0.0 < float(stats["intra_fraction"].mean()) < 1.0
    # The parity is the geometry: inside the sphere <=> even transits.
    inside = np.linalg.norm(pos, axis=1) < RADIUS
    assert float((inside != (stats["crossings"] % 2 == 0)).mean()) < 0.01
    # impermeable compartment: no transits at all
    _, stats0 = _run(n_s, D, gradient, dt, substrates.sphere(RADIUS), seed=5,
                     exchange_stats=True)
    assert stats0["crossings"].sum() == 0
    npt.assert_array_equal(stats0["intra_steps"], n_t)
    # two-compartment T2: heavy extra-cellular decay lowers the signal of
    # a permeable sphere; the weighted signal is the weight sum (b = 0).
    t2i, t2e = 1.0, 1e-3
    s_w = _run(n_s, D, gradient, dt, substrate, seed=5,
               relaxation=(t2i, t2e))
    s_u = _run(n_s, D, gradient, dt, substrate, seed=5)
    assert float(s_w[0]) < float(s_u[0])
    npt.assert_allclose(
        s_w[0], _weights(stats["intra_steps"], n_t, dt, t2i, t2e).sum(),
        rtol=1e-5)


def _sphere_walk(n_s, n_t, seed, azimuth_first):
    """The classic engine's permeable-sphere run (sphere_* setup) as a
    loop over ``stepping.step_sphere`` with the port's draws; with
    ``azimuth_first`` the first collision of each step draws the uniform
    that set the step's azimuth, as the JAX package's classic engine does
    (its ``rng.bounce_key(step_k, 0)`` is the key of the azimuth uniform in
    ``rng.random_unit_steps``). Returns (crossings, intra_steps)."""
    dt = 2e-4
    scale = 1.0 / np.sqrt(6 * D * dt)
    np.random.seed(seed)
    pos = torch.as_tensor(simulations._fill_sphere(n_s, RADIUS).T * scale,
                          dtype=torch.float32)
    spec = SphereSpec(radius=torch.tensor(RADIUS * scale),
                      perm_prob=torch.tensor(0.5))
    eps = simulations._effective_epsilon(1e-13, scale, RADIUS * scale, n_t,
                                         torch.float32, True)
    ids = torch.arange(n_s, dtype=torch.int32)
    seed_k = seed ^ core.CLASSIC_SALT
    crossings = torch.zeros(n_s, dtype=torch.int32)
    parity = torch.ones(n_s, dtype=torch.bool)
    intra = torch.zeros(n_s, dtype=torch.int32)
    for t in range(n_t):
        _, w1 = krng.step_words(seed_k, t, ids, 0)
        uniform = rng.bounce_uniforms(seed_k, t, ids, torch.float32)

        def draw(bounce, idx=None, w1=w1, uniform=uniform):
            if azimuth_first and bounce == 0:
                return krng.uniform01(w1)
            return uniform(bounce, idx)

        pos, _, cross = stepping.step_sphere(
            pos, spec, eps, 1000, rng.step_directions(seed_k, t, ids,
                                                      torch.float32), draw)
        crossings += cross
        parity ^= (cross & 1).bool()
        intra += parity.to(torch.int32)
    return crossings.numpy(), intra.numpy()


def test_classic_sphere_stats_match_jax(jax_runs):
    # The setup of scripts/make_torch_oracles.py's sphere_* run. The port's
    # draws are independent per collision; the JAX package's first
    # collision of a step reuses the azimuth uniform (ROADMAP section 3),
    # which lowers its crossing rate (measured 2.19 against the port's
    # 2.64-2.80 per spin). Fed that correlation, the port's step reproduces
    # the JAX statistics; without it, the loop is simulation() exactly.
    n_s, n_t, seed = 1200, 60, 5
    _, stats = _run(n_s, D, np.zeros((1, n_t, 3)), 2e-4,
                    substrates.sphere(RADIUS, perm_prob=0.5), seed=seed,
                    exchange_stats=True)
    crossings, intra = _sphere_walk(n_s, n_t, seed, azimuth_first=False)
    npt.assert_array_equal(stats["crossings"], crossings)
    npt.assert_array_equal(stats["intra_steps"], intra)
    crossings, intra = _sphere_walk(n_s, n_t, seed, azimuth_first=True)
    for port, ref in (
        (crossings, jax_runs["sphere_crossings"]),
        (intra / n_t, jax_runs["sphere_intra_steps"] / n_t),
    ):
        port, ref = port.astype(float), ref.astype(float)
        se = np.sqrt(port.var() / len(port) + ref.var() / len(ref))
        assert abs(port.mean() - ref.mean()) <= 4 * se, (port.mean(),
                                                         ref.mean(), se)


def test_fused_tracking_matches_jax(oracles_dir, jax_runs):
    # The setup of scripts/make_torch_oracles.py's fused_* run.
    n_s, n_t, seed, dt = 512, 10, 3, 1.2e-4
    with open(oracles_dir / "cylinder_mesh_closed.pkl", "rb") as f:
        mesh = pickle.load(f)
    kw = dict(n_sv=np.array([10, 10, 10]), quiet=True)
    start = simulations._fill_mesh(
        n_s, substrates.mesh(mesh["vertices"], mesh["faces"], True, **kw),
        True, 5, "cpu")
    sub = substrates.mesh(mesh["vertices"], mesh["faces"], True,
                          init_pos=start, perm_prob=0.5, **kw)
    bs = np.linspace(1, 3e9, 4)
    gradient = np.zeros((1, 700, 3))
    gradient[0, 1:300, 0] = 1
    gradient[0, -300:-1, 0] = -1
    gradient = np.concatenate([gradient for _ in bs], axis=0)
    gradient, _ = gradients.interpolate_gradient(gradient, 70e-3 / 699, n_t)
    gradient = gradients.set_b(gradient, dt, bs)
    config.use_fused = True
    try:
        signals, pos, stats = _run(
            n_s, D, gradient, dt, sub, seed=seed, final_pos=True,
            all_signals=True, relaxation=(T2I, T2E), exchange_stats=True)
    finally:
        config.use_fused = None
    assert jax_runs["fused_crossings"].sum() > 0
    same = ((stats["crossings"] == jax_runs["fused_crossings"])
            & (stats["intra_steps"] == jax_runs["fused_intra_steps"]))
    assert same.mean() >= 0.99, same.mean()
    step_l = np.sqrt(6 * D * dt)
    err = np.abs(pos - jax_runs["fused_pos"]).max(axis=1) / step_l
    assert np.mean(err <= 1e-4) >= 0.99, np.mean(err <= 1e-4)
    npt.assert_allclose(signals, jax_runs["fused_signals"], rtol=0, atol=1e-5)
