"""The classic engine's one-program step on the CPU (no JAX needed).

- ``core.run_window`` now runs every time step as one ``core.step_body``
  on a ``ClassicState`` whose step scalars (draw key, step, step index)
  live in device tensors, as a CUDA graph replay needs them; on the card
  each step is a replay of one captured body (``chip_smoke.py`` phase 19
  holds the graph to the eager body bit for bit). Here the body, run
  eagerly, must equal the loop it replaced (Python-int draw keys, a new
  phase tensor per step, ``trajectory[i] = positions``) bit for bit for
  free diffusion, sphere, cylinder, ellipsoid and a mesh, untracked,
  tracked, with trajectories and as a two-block sweep.
- A serial loop, one spin at a time, each spin drawing the uniform of its
  k-th collision check at bounce index k - 1 (the order the step kernels
  K8 and K9 draw in), equals the batched plain loops bit for bit, with
  perm 0 and 0.5.
- The start classifier on "cpu" gives the same parities whatever its
  batches, equal to an unbatched count over every triangle, and the
  neuron mesh's stored JAX parities.
- A CPU window launches no kernel; the kernels' CUDA entry points refuse
  CPU tensors.
"""

import pickle

import numpy as np
import numpy.testing as npt
import pytest
import torch

from disimpy_tpu_torch import meshes, simulations, substrates
from disimpy_tpu_torch.engine import (analytic_kernel, config, core, krng,
                                      launch_count, mesh_accel, mesh_kernel,
                                      rng, specs, stepping)

import torch_threads  # noqa: F401  (shares the cores among xdist workers)

N_SPINS, N_STEPS, N_MEAS, SEED = 48, 6, 3, 21
STEP_L = float(np.sqrt(6 * 2e-9 * 8e-5))
KINDS = ("free", "sphere", "cylinder", "ellipsoid", "mesh")


def _loop_before(kind, spec, positions, phases, iter_exc, g_eff, ts, seed32,
                 epsilon, max_iter, collect_positions=False, track=None,
                 compartments=None, ids=None, blocks=1):
    """``core.run_window``'s step loop as it was before ``step_body``."""
    step_fn = stepping.STEP_FUNCTIONS[kind]
    n = positions.shape[1]
    dtype = positions.dtype
    if ids is None:
        ids = torch.arange(n, dtype=torch.int32)
    seed_k = int(seed32) ^ (core.FREE_SALT if kind == "free"
                            else core.CLASSIC_SALT)
    width = n // blocks
    if track == "exchange":
        crossings, parity, intra_steps = compartments
    trajectory = None
    if collect_positions:
        trajectory = torch.empty((len(ts), 3, n), dtype=dtype)
    for i, t in enumerate(ts):
        positions, exc_t, cross_t = step_fn(
            positions, spec, epsilon, max_iter,
            rng.step_directions(seed_k, t, ids, dtype),
            rng.bounce_uniforms(seed_k, t, ids, dtype),
        )
        if blocks == 1:
            phases = phases + g_eff[i] @ positions
        else:
            phases = torch.cat([
                phases[:, b * width:(b + 1) * width]
                + g_eff[i] @ positions[:, b * width:(b + 1) * width]
                .contiguous()
                for b in range(blocks)
            ], dim=1)
        iter_exc = iter_exc | exc_t
        if track == "exchange":
            crossings = crossings + cross_t
            parity = parity ^ (cross_t & 1).bool()
            intra_steps = intra_steps + parity.to(torch.int32)
        if collect_positions:
            trajectory[i] = positions
    if track == "exchange":
        return ((positions, phases, iter_exc), trajectory,
                (crossings, parity, intra_steps))
    return (positions, phases, iter_exc), trajectory


@pytest.fixture(scope="module")
def icosphere():
    vertices, faces = meshes.icosphere(radius=5e-6, subdivisions=2)
    sub = substrates.mesh(vertices, faces, True, n_sv=np.array([4, 4, 4]),
                          quiet=True)
    return sub, vertices


def _case(kind, perm, icosphere, n=N_SPINS, dtype=torch.float32):
    """(spec, positions (3, n), epsilon) in step lengths: spins inside a
    compartment a few steps across, so they bounce."""
    rs = np.random.RandomState(5)
    ball = rs.uniform(-1, 1, (8 * n, 3))
    ball = ball[np.linalg.norm(ball, axis=1) < 1][:n]

    def scalar(x):
        return torch.tensor(x, dtype=dtype)

    if kind == "free":
        spec, pos = specs.FreeSpec(), ball
    elif kind == "sphere":
        spec, pos = specs.SphereSpec(scalar(3.0), scalar(perm)), 3.0 * ball
    elif kind == "cylinder":
        spec = specs.CylinderSpec(scalar(2.0), scalar(perm))
        pos = ball * np.array([5.0, 2.0, 2.0])
    elif kind == "ellipsoid":
        ax = np.array([3.0, 2.5, 2.0])
        spec = specs.EllipsoidSpec(torch.tensor(ax, dtype=dtype),
                                   scalar(perm))
        pos = ball * ax
    else:
        sub, vertices = icosphere
        spec = mesh_accel.pack_mesh(sub, 1 / STEP_L, dtype)
        spec = specs.MeshSpec(**{
            **{f: getattr(spec, f) for f in ("tri", "cell_counts",
                                             "voxel_size", "sv_width")},
            "perm_prob": scalar(perm), "n_sv": spec.n_sv,
            "spans": spec.spans, "chunk": spec.chunk})
        # A shell within a step of the facets (the inradius is ~0.95 r).
        centre = vertices.mean(axis=0) / STEP_L
        shell = ball / np.linalg.norm(ball, axis=1, keepdims=True)
        pos = centre + (5e-6 / STEP_L) * rs.uniform(0.75, 0.9, (n, 1)) * shell
    eps = 64 * float(np.finfo(np.float32).eps) * 8.0
    return spec, torch.tensor(pos.T, dtype=dtype).contiguous(), eps


def _window_args(positions, dtype=torch.float32):
    n = positions.shape[1]
    g_eff = torch.tensor(np.random.RandomState(7).standard_normal(
        (N_STEPS, N_MEAS, 3)), dtype=dtype)
    return (positions, torch.zeros((N_MEAS, n), dtype=dtype),
            torch.zeros(n, dtype=torch.bool), g_eff, range(3, 3 + N_STEPS),
            SEED)


def _flat(out):
    flat = []
    for o in out:
        if isinstance(o, tuple):
            flat.extend(_flat(o))
        elif o is not None:
            flat.append(o)
    return flat


def _assert_same(a, b):
    a, b = _flat(a), _flat(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


@pytest.mark.parametrize("window", ["plain", "tracked", "trajectory"])
@pytest.mark.parametrize("kind", KINDS)
def test_step_body_equals_the_loop_it_replaced(kind, window, icosphere):
    perm = 0.0 if window == "plain" else 0.5
    spec, pos, eps = _case(kind, perm, icosphere)
    args = (kind, spec, *_window_args(pos), eps, 1000)
    kw = {}
    if window == "tracked":
        n = pos.shape[1]
        kw = dict(track="exchange", compartments=(
            torch.zeros(n, dtype=torch.int32),
            torch.from_numpy(np.random.RandomState(2).random_sample(n) < 0.5),
            torch.zeros(n, dtype=torch.int32)))
    elif window == "trajectory":
        kw = dict(collect_positions=True)
    before = [t.clone() for t in _flat(args[2:5])]
    want = _loop_before(*args, **kw)
    got = core.run_window(*args, **kw)
    _assert_same(got, want)
    # The arguments are not modified.
    for x, y in zip(before, _flat(args[2:5])):
        assert torch.equal(x, y)
    if window == "tracked" and kind != "free":
        assert int(got[2][0].sum()) > 0  # spins crossed the membrane


def test_step_body_equals_the_loop_as_a_sweep(icosphere):
    # A two-block sweep: one radius and one epsilon per spin, ids repeated.
    spec, pos, _ = _case("sphere", 0.0, icosphere)
    n = pos.shape[1]
    radius = torch.cat([torch.full((n,), 3.0), torch.full((n,), 2.0)])
    eps = torch.cat([torch.full((n,), 1e-4), torch.full((n,), 2e-4)])
    spec = specs.SphereSpec(radius, torch.tensor(0.0))
    pos2 = torch.cat([pos, pos * (2.0 / 3.0)], dim=1)
    ids = torch.arange(n, dtype=torch.int32).repeat(2)
    args = ("sphere", spec, *_window_args(pos2), eps, 1000)
    _assert_same(core.run_window(*args, ids=ids, blocks=2),
                 _loop_before(*args, ids=ids, blocks=2))


def test_run_window_takes_consecutive_steps():
    args = ("free", specs.FreeSpec(), torch.zeros((3, 2)),
            torch.zeros((1, 2)), torch.zeros(2, dtype=torch.bool),
            torch.zeros((2, 1, 3)))
    with pytest.raises(ValueError):
        core.run_window(*args, [0, 2], 0, 1e-6, 10)
    (positions, _, _), _ = core.run_window(*args, range(4, 6), 0, 1e-6, 10)
    assert positions.abs().sum() > 0


def _serial(kind, positions, spec, eps, max_iter, seed_k, t, ids):
    """The step run one spin at a time, each spin drawing the uniform of
    its k-th collision check at bounce index k - 1."""
    dtype = positions.dtype
    outs = []
    for i in range(positions.shape[1]):
        sel = ids[i:i + 1]
        checks = []

        def uniform(bounce, idx=None, sel=sel, checks=checks):
            bounce = int(bounce) if not isinstance(bounce, int) else bounce
            checks.append(bounce)
            assert checks == list(range(len(checks)))
            return krng.bounce_uniform(seed_k, t, sel, bounce, dtype)

        outs.append(stepping.STEP_FUNCTIONS[kind](
            positions[:, i:i + 1].contiguous(), spec, eps, max_iter,
            rng.step_directions(seed_k, t, sel, dtype), uniform))
    return tuple(torch.cat([o[k] for o in outs], dim=-1) for k in range(3))


@pytest.mark.parametrize("perm", [0.0, 0.5])
@pytest.mark.parametrize("kind", ["sphere", "cylinder", "ellipsoid", "mesh"])
def test_serial_draw_order_equals_the_batched_loop(kind, perm, icosphere):
    spec, pos, eps = _case(kind, perm, icosphere, n=32)
    ids = torch.arange(100, 132, dtype=torch.int32)
    want = stepping.step(kind, pos, spec, eps, 1000, SEED, 9, ids)
    got = _serial(kind, pos, spec, eps, 1000, SEED, 9, ids)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(want[2].sum()) > 0 or perm == 0.0
    assert not bool(want[1].any())


def _brute_parity(substrate, points):
    """Crossing parity of the +x ray over every triangle, one batch."""
    triangles = torch.as_tensor(substrate.vertices[substrate.faces],
                                dtype=torch.float32)
    pts = torch.as_tensor(np.asarray(points, dtype=np.float32))
    all_ids = torch.arange(len(triangles)).expand(len(pts), -1)
    return (simulations._count_crossings_x(pts, triangles, all_ids) % 2
            ).bool().numpy()


def test_classifier_parities_do_not_depend_on_batching(icosphere,
                                                       oracles_dir):
    sub, _ = icosphere
    points = np.random.RandomState(3).random_sample((3000, 3)) * np.asarray(
        sub.voxel_size)
    want = _brute_parity(sub, points)
    assert 0 < want.sum() < len(want)
    for budget in (None, 700, 1):
        npt.assert_array_equal(
            simulations._make_intra_classifier(sub, "cpu", budget)(points),
            want)
    # The neuron mesh (non-periodic: its voxel walls are left out) against
    # the JAX package's classifier, stored by make_torch_oracles.py.
    with np.load(oracles_dir / "jax_reference_runs.npz") as data:
        neuron_points = data["neuron_points"]
        neuron_inside = data["neuron_inside"]
    with open(oracles_dir / "neuron-model.pkl", "rb") as f:
        mesh = pickle.load(f)
    neuron = substrates.mesh(mesh["vertices"], mesh["faces"], False,
                             n_sv=np.array([20, 20, 20]), quiet=True)
    npt.assert_array_equal(
        simulations._make_intra_classifier(neuron, "cpu", 50_000)(
            neuron_points), neuron_inside)


def test_cpu_window_launches_no_kernel(icosphere, monkeypatch):
    monkeypatch.setattr(launch_count, "counts",
                        dict.fromkeys(launch_count.KERNELS, 0))
    for kind in KINDS:
        spec, pos, eps = _case(kind, 0.5, icosphere, n=16)
        core.run_window(kind, spec, *_window_args(pos), eps, 1000)
    assert not any(launch_count.counts.values())


def test_kernel_entry_points_refuse_cpu_tensors(icosphere):
    ids = torch.arange(8, dtype=torch.int32)
    spec, pos, eps = _case("sphere", 0.0, icosphere, n=8)
    with pytest.raises(ValueError):
        analytic_kernel.analytic_step("sphere", pos, spec, eps, 10, 1, 0, ids)
    spec, pos, eps = _case("mesh", 0.0, icosphere, n=8)
    with pytest.raises(ValueError):
        mesh_kernel.mesh_step(spec, pos, eps, 10, 1, 0, ids)
    # No step syncs the host on CUDA, the per-cell layout's included: both
    # layouts have their kernels there (K2 and K9; K10 and K9's remainder),
    # which take CUDA tensors only; the CPU runs the plain loops.
    per_cell = specs.MeshSpec(**{**spec.__dict__, "spans": (3, 3, 3)})
    for s in (spec, per_cell):
        assert config.mesh_query_backend(s, torch.float32, "cuda") == "kernel"
        assert config.mesh_query_backend(s, torch.float32, "cpu") == "gather"
    with pytest.raises(ValueError):
        mesh_kernel.mesh_step(per_cell, pos, eps, 10, 1, 0, ids)
