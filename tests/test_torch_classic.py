"""The port's classic engine against the JAX package, on the CPU.

- ``mesh_accel.pack_mesh`` gives the JAX pack's arrays (the NumPy code is
  the same), in the halo and the per-cell layout.
- The nearest-hit query: the CUDA kernel's plain version
  (``mesh_kernel.nearest_hit_reference``) and the gather query
  (``mesh_accel.nearest_hit``) against the JAX package's Pallas kernel in
  interpret mode (its answer stored by ``scripts/make_torch_oracles.py``)
  and its XLA query, on one table built by the JAX pack
  and carried over with ``spec_from_numpy``. Hit masks are equal;
  distances agree to 1e-6 step lengths and normals to |dot| = 1 within
  1e-5 (float32); in float64 distances agree to 1e-12.
- The step functions, fed the JAX engine's own draws (the port keys its
  draws with krng and cannot reproduce ``jax.random``): positions agree to
  float32 rounding (1e-5 step lengths), ``exc`` and crossing counts are
  equal. The JAX mesh step draws its later uniforms per compacted slot,
  not per spin, so permeable ``step_mesh`` is held to its crossing rate.
- The samplers draw the JAX package's positions under the same seed.
- ``simulation(device="cpu")`` runs the analytic substrates, float64,
  trajectories and the meshes the fused engine hands over to the classic
  one; free diffusion gives bitwise what it gave before the classic
  engine took it over.
"""

import pickle

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax
import jax.numpy as jnp

from disimpy_tpu import meshes as jmeshes
from disimpy_tpu import simulations as jsim
from disimpy_tpu import substrates as jsub
from disimpy_tpu.engine import mesh_accel as jaccel
from disimpy_tpu.engine import rng as jrng
from disimpy_tpu.engine import specs as jspecs
from disimpy_tpu.engine import stepping as jstep
from disimpy_tpu_torch import gradients, meshes, simulations, substrates
from disimpy_tpu_torch.engine import (config, core, geometry, krng,
                                      launch_count, mesh_accel, mesh_kernel,
                                      specs, stepping)

import torch_threads  # noqa: F401  (shares the cores among xdist workers)

D = 2e-9
STEP_L = float(np.sqrt(6 * D * 8e-5))
MESH_FIELDS = ("tri", "cell_counts", "voxel_size", "sv_width", "perm_prob")


def _icosphere(mod, mesh_mod):
    vertices, faces = mesh_mod.icosphere(radius=5e-6, subdivisions=2)
    return mod.mesh(vertices, faces, True, n_sv=np.array([4, 4, 4]),
                    quiet=True)


def _port_spec(jspec, device="cpu"):
    """The JAX pack carried into the port."""
    arrays = {k: np.asarray(getattr(jspec, k)) for k in MESH_FIELDS}
    meta = dict(kind="mesh", n_sv=jspec.n_sv, spans=jspec.spans,
                chunk=jspec.chunk)
    return specs.spec_from_numpy(arrays, meta, device)


@pytest.fixture(scope="module")
def icospheres():
    return _icosphere(jsub, jmeshes), _icosphere(substrates, meshes)


@pytest.fixture(scope="module")
def query_case():
    """The 700-spin query of tests/test_pallas_mesh.py (spins partly
    outside the voxel, so the periodic wrap is exercised)."""
    sub = _icosphere(jsub, jmeshes)
    rng = np.random.RandomState(1)
    n = 700
    voxel = np.asarray(sub.voxel_size) / STEP_L
    r0 = (rng.random_sample((n, 3)) * 1.4 - 0.2) * voxel
    direction = rng.standard_normal((n, 3))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    rem = rng.random_sample(n)
    return sub, r0, direction, rem


# ---------------------------------------------------------------------------
# (a) The pack.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["halo", "per-cell"])
def test_pack_mesh_equals_jax(icospheres, monkeypatch, layout, query_case):
    if layout == "per-cell":
        monkeypatch.setattr(jaccel, "HALO_BYTES_LIMIT", 0)
        monkeypatch.setattr(mesh_accel, "HALO_BYTES_LIMIT", 0)
    sub_j, sub_t = icospheres
    spec_j = jaccel.pack_mesh(sub_j, 1 / STEP_L, jnp.float32)
    spec_t = mesh_accel.pack_mesh(sub_t, 1 / STEP_L, torch.float32)
    assert (spec_t.spans == (1, 1, 1)) == (layout == "halo")
    for k in MESH_FIELDS:
        npt.assert_array_equal(getattr(spec_t, k).numpy(),
                               np.asarray(getattr(spec_j, k)), err_msg=k)
    assert spec_t.tri.dtype == torch.float32
    assert spec_t.cell_counts.dtype == torch.int32
    for k in ("n_sv", "spans", "chunk"):
        assert getattr(spec_t, k) == getattr(spec_j, k), k
    # The gather query on this layout equals the JAX package's XLA query
    # on the same inputs (same arithmetic; float32 rounding may differ in
    # the last ulp): equal hit masks, d within 1e-6 step lengths.
    _, r0, direction, rem = query_case
    d_j, n_j = jaccel.nearest_hit(
        spec_j, jnp.asarray(r0, jnp.float32), jnp.asarray(direction, jnp.float32),
        jnp.asarray(rem, jnp.float32), edge_tol=1e-5)
    d_t, n_t = mesh_accel.nearest_hit(
        spec_t, torch.tensor(r0, dtype=torch.float32),
        torch.tensor(direction, dtype=torch.float32),
        torch.tensor(rem, dtype=torch.float32), edge_tol=1e-5)
    _assert_same_hits(d_t.numpy(), n_t.numpy(), np.asarray(d_j),
                      np.asarray(n_j), rem, 1e-6)


# ---------------------------------------------------------------------------
# (b) The query; (c) the tie.
# ---------------------------------------------------------------------------


def _assert_same_hits(d_a, n_a, d_b, n_b, rem, d_tol, min_hits=20):
    hits_a, hits_b = d_a <= rem, d_b <= rem
    npt.assert_array_equal(hits_a, hits_b)
    assert hits_a.sum() > min_hits  # the case exercises collisions
    npt.assert_allclose(d_a[hits_a], d_b[hits_a], rtol=0, atol=d_tol)
    alignment = np.abs(np.sum(n_a[hits_a] * n_b[hits_a], axis=1))
    npt.assert_allclose(alignment, 1.0, atol=1e-5)
    # No hit anywhere: inf and a zero normal.
    none = ~np.isfinite(d_a)
    npt.assert_array_equal(n_a[none], 0.0)


def test_query_float32_matches_pallas_and_xla(query_case, oracles_dir):
    sub, r0, direction, rem = query_case
    spec_j = jaccel.pack_mesh(sub, 1 / STEP_L, jnp.float32)
    assert spec_j.spans == (1, 1, 1)
    r0_j, dir_j, rem_j = (jnp.asarray(x, jnp.float32)
                          for x in (r0, direction, rem))
    # The Pallas kernel's answer in interpret mode on this query, stored by
    # scripts/make_torch_oracles.py (query_pallas_*).
    with np.load(oracles_dir / "jax_reference_runs.npz") as data:
        d_pl, n_pl = data["query_pallas_d"], data["query_pallas_n"]
    d_x, n_x = jaccel.nearest_hit(spec_j, r0_j, dir_j, rem_j, edge_tol=1e-5)

    spec_t = _port_spec(spec_j)
    args = [torch.tensor(x, dtype=torch.float32) for x in (r0, direction, rem)]
    launched = launch_count.counts["mesh_hit"]
    d_t, n_t = mesh_kernel.nearest_hit(spec_t, *args)  # CPU: plain version
    # No kernel on a CPU tensor.
    assert launch_count.counts["mesh_hit"] == launched
    rem32 = np.asarray(rem_j)
    for d_ref, n_ref in ((d_pl, n_pl), (d_x, n_x)):
        _assert_same_hits(d_t.numpy(), n_t.numpy(), np.asarray(d_ref),
                          np.asarray(n_ref), rem32, 1e-6)
    # The cell the kernel reads is the one the plain version reads.
    cell, shifted = mesh_kernel.halo_cells(spec_t, *args)
    n_sv = np.array(spec_t.n_sv)
    seg_end = r0 + direction * rem[:, None]
    base = np.floor(np.minimum(r0, seg_end) / spec_t.sv_width.numpy())
    wrapped = np.mod(base, n_sv).astype(int)
    npt.assert_array_equal(
        cell.numpy(), (wrapped[:, 0] * n_sv[1] + wrapped[:, 1]) * n_sv[2]
        + wrapped[:, 2])
    npt.assert_allclose(shifted.numpy(),
                        r0 - (base - wrapped) / n_sv * spec_t.voxel_size.numpy(),
                        rtol=0, atol=1e-4)


def test_query_float64_matches_xla(query_case):
    sub, r0, direction, rem = query_case
    with jax.enable_x64(True):
        spec_j = jaccel.pack_mesh(sub, 1 / STEP_L, jnp.float64)
        d_x, n_x = jaccel.nearest_hit(
            spec_j, *(jnp.asarray(x, jnp.float64) for x in (r0, direction, rem)),
            edge_tol=1e-12)
        d_x, n_x = np.asarray(d_x), np.asarray(n_x)
        spec_t = _port_spec(spec_j)
    assert spec_t.tri.dtype == torch.float64
    d_t, n_t = mesh_kernel.nearest_hit(
        spec_t, *(torch.tensor(x, dtype=torch.float64)
                  for x in (r0, direction, rem)))
    assert d_t.dtype == torch.float64
    _assert_same_hits(d_t.numpy(), n_t.numpy(), d_x, n_x, rem, 1e-12)


def _single_cell_spec(records):
    """A one-cell halo spec holding ``records`` (k, 12) in a 100-wide
    voxel."""
    K = len(records)
    tri = torch.zeros((1, 1, K, 12), dtype=torch.float32)
    tri[0, 0] = torch.tensor(np.array(records), dtype=torch.float32)
    f32 = dict(dtype=torch.float32)
    return specs.MeshSpec(
        tri=tri, cell_counts=torch.tensor([K], dtype=torch.int32),
        voxel_size=torch.full((3,), 100.0, **f32),
        sv_width=torch.full((3,), 100.0, **f32),
        perm_prob=torch.tensor(0.0, **f32), n_sv=(1, 1, 1), spans=(1, 1, 1),
        chunk=K,
    )


def test_tie_break_returns_one_triangles_normal():
    """The tent of tests/test_pallas_mesh.py: two triangles sharing an
    edge, hit on the edge. The normal returned is one triangle's, never a
    mix; and two records with the same geometry resolve to the first."""
    o = np.array([10.0, 10.0, 10.0] * 3)
    t1 = np.array([0, 0, 0, 0, 1, 0, 1, 0, -0.75]) + o
    n1 = np.array([-0.6, 0.0, -0.8])
    t2 = np.array([0, 0, 0, 0, 1, 0, -1, 0, -4.0 / 3.0]) + o
    n2 = np.array([-0.8, 0.0, 0.6])
    spec = _single_cell_spec([np.r_[t1, n1], np.r_[t2, n2]])
    r0 = torch.tensor([[10.0, 10.5, 9.0]])
    up = torch.tensor([[0.0, 0.0, 1.0]])
    rem = torch.tensor([2.0])
    for query in (mesh_kernel.nearest_hit,
                  lambda *a: mesh_accel.nearest_hit(*a, edge_tol=1e-5)):
        d, normal = query(spec, r0, up, rem)
        normal = normal[0].numpy()
        npt.assert_allclose(float(d[0]), 1.0, atol=1e-6)
        npt.assert_allclose(np.linalg.norm(normal), 1.0, atol=1e-6)
        assert (np.allclose(np.abs(normal @ n1), 1.0, atol=1e-6)
                or np.allclose(np.abs(normal @ n2), 1.0, atol=1e-6)), normal
    # Exact tie: the same triangle twice, told apart by its stored normal.
    spec = _single_cell_spec([np.r_[t1, n1], np.r_[t1, -n2]])
    for query in (mesh_kernel.nearest_hit,
                  lambda *a: mesh_accel.nearest_hit(*a, edge_tol=1e-5)):
        d, normal = query(spec, r0, up, rem)
        npt.assert_array_equal(normal[0].numpy(), n1.astype(np.float32))


def test_query_backend_and_kernel_layout_checks(icospheres, monkeypatch):
    _, sub = icospheres
    halo = mesh_accel.pack_mesh(sub, 1 / STEP_L, torch.float32)
    for dtype in (torch.float32, torch.float64):
        assert config.mesh_query_backend(halo, dtype, "cuda") == "kernel"
        assert config.mesh_query_backend(halo, dtype, "cpu") == "gather"
    with pytest.raises(ValueError):
        config.mesh_query_backend(halo, torch.float16, "cuda")
    monkeypatch.setattr(mesh_accel, "HALO_BYTES_LIMIT", 0)
    per_cell = mesh_accel.pack_mesh(sub, 1 / STEP_L, torch.float32)
    # The per-cell layout has its kernel (K10) on the card; a CPU tensor
    # runs the gather query on either layout.
    assert config.mesh_query_backend(per_cell, torch.float32, "cuda") == "kernel"
    assert config.mesh_query_backend(per_cell, torch.float32, "cpu") == "gather"
    x = torch.zeros((4, 3))
    up = torch.tensor([[0.0, 0.0, 1.0]] * 4)
    got = mesh_kernel.nearest_hit(per_cell, x, up, torch.ones(4))
    want = mesh_accel.nearest_hit(per_cell, x, up, torch.ones(4),
                                  edge_tol=1e-5)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="positive"):
        mesh_kernel._check_spec(
            specs.MeshSpec(**{**per_cell.__dict__, "spans": (0, 1, 1)}),
            torch.device("cpu"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        mesh_kernel.nearest_hit(halo, x.to("meta"), x.to("meta"),
                                torch.ones(4, device="meta"))


# ---------------------------------------------------------------------------
# (d) Step functions, fed the JAX engine's draws.
# ---------------------------------------------------------------------------

N_STEP = 512
MAX_BOUNCES = 64
_jit_steps = {kind: jax.jit(jstep.STEP_FUNCTIONS[kind])
              for kind in ("sphere", "cylinder", "ellipsoid", "mesh")}


def _fed_draws(key, n, mesh=False):
    """The JAX step's directions (3, n) and its per-pass uniforms, as the
    port's ``directions`` and ``uniform(bounce, idx)``."""
    dir_key = jrng.bounce_key(key, 0) if mesh else key
    directions = np.array(jrng.random_unit_steps(dir_key, n, jnp.float32))
    # Analytic pass b draws with bounce_key(key, b); the mesh step's first
    # pass with bounce_key(key, 1).
    first = 1 if mesh else 0
    table = np.stack([
        np.asarray(jrng.uniforms(jrng.bounce_key(key, first + b), n,
                                 jnp.float32))
        for b in range(1 if mesh else MAX_BOUNCES)
    ])
    table = torch.from_numpy(table)

    def uniform(bounce, idx=None):
        if not isinstance(bounce, int):
            # Later mesh passes: JAX draws per compacted slot.
            return krng.bounce_uniform(7, 0, idx.to(torch.int32), bounce)
        assert bounce < len(table), "more passes than fed uniforms"
        return table[bounce] if idx is None else table[bounce][idx]

    return torch.from_numpy(directions), uniform


def _analytic_case(kind, perm):
    """Positions inside the compartment and the JAX and port specs, in step
    lengths (compartments ~3 steps across, so spins bounce)."""
    rng = np.random.RandomState(5)
    f32 = jnp.float32
    if kind == "sphere":
        r = 3.0
        pos = rng.uniform(-1, 1, (4 * N_STEP, 3)) * r
        pos = pos[np.linalg.norm(pos, axis=1) < r][:N_STEP]
        spec_j = jspecs.SphereSpec(radius=jnp.asarray(r, f32),
                                   perm_prob=jnp.asarray(perm, f32))
        spec_t = specs.spec_from_numpy(
            dict(radius=np.float32(r), perm_prob=np.float32(perm)),
            dict(kind="sphere"), "cpu")
    elif kind == "cylinder":
        r = 2.0
        pos = rng.uniform(-1, 1, (4 * N_STEP, 3)) * r
        pos = pos[np.linalg.norm(pos[:, 1:], axis=1) < r][:N_STEP]
        spec_j = jspecs.CylinderSpec(radius=jnp.asarray(r, f32),
                                     perm_prob=jnp.asarray(perm, f32))
        spec_t = specs.spec_from_numpy(
            dict(radius=np.float32(r), perm_prob=np.float32(perm)),
            dict(kind="cylinder"), "cpu")
    else:
        ax = np.array([3.0, 2.5, 2.0], np.float32)
        pos = rng.uniform(-1, 1, (4 * N_STEP, 3)) * ax
        pos = pos[np.sum((pos / ax) ** 2, axis=1) < 1][:N_STEP]
        spec_j = jspecs.EllipsoidSpec(semiaxes=jnp.asarray(ax),
                                      perm_prob=jnp.asarray(perm, f32))
        spec_t = specs.spec_from_numpy(
            dict(semiaxes=ax, perm_prob=np.float32(perm)),
            dict(kind="ellipsoid"), "cpu")
    assert len(pos) == N_STEP
    return pos.T.astype(np.float32), spec_j, spec_t


def _compare_step(kind, pos, spec_j, spec_t, eps, key, mesh=False):
    (p_j, exc_j, cr_j) = _jit_steps[kind](
        jnp.asarray(pos), key, spec_j, jnp.asarray(eps, jnp.float32),
        jnp.asarray(1000, jnp.int32))
    directions, uniform = _fed_draws(key, pos.shape[1], mesh=mesh)
    p_t, exc_t, cr_t = stepping.STEP_FUNCTIONS[kind](
        torch.from_numpy(pos), spec_t, eps, 1000, directions, uniform)
    return (np.asarray(p_j), np.asarray(exc_j), np.asarray(cr_j),
            p_t.numpy(), exc_t.numpy(), cr_t.numpy())


@pytest.mark.parametrize("perm", [0.0, 0.5])
@pytest.mark.parametrize("kind", ["sphere", "cylinder", "ellipsoid"])
def test_analytic_step_matches_jax(kind, perm):
    pos, spec_j, spec_t = _analytic_case(kind, perm)
    eps = 64 * float(np.finfo(np.float32).eps) * 3.0
    p_j, exc_j, cr_j, p_t, exc_t, cr_t = _compare_step(
        kind, pos, spec_j, spec_t, eps, jax.random.PRNGKey(11))
    npt.assert_array_equal(exc_t, exc_j)
    npt.assert_array_equal(cr_t, cr_j)
    npt.assert_allclose(p_t, p_j, rtol=0, atol=1e-5)
    moved = np.linalg.norm(p_t - pos, axis=0)
    assert np.all(moved <= 1.0 + 1e-5)
    # The case bounces: some spins end off their straight-line step.
    directions, _ = _fed_draws(jax.random.PRNGKey(11), N_STEP)
    off = np.linalg.norm(p_t - (pos + directions.numpy()), axis=0) > 1e-4
    assert off.sum() > 20
    if perm:
        assert cr_t.sum() > 10  # the permeable branch is exercised


@pytest.fixture(scope="module")
def mesh_step_case(icospheres):
    sub_j, _ = icospheres
    spec_j = jaccel.pack_mesh(sub_j, 1 / STEP_L, jnp.float32)
    vox = np.asarray(sub_j.voxel_size) / STEP_L
    pos = (np.random.RandomState(3).random_sample((N_STEP, 3)) * vox).T
    eps = 64 * float(np.finfo(np.float32).eps) * 3.0 * np.sqrt(10)
    return spec_j, pos.astype(np.float32), eps


def test_mesh_step_matches_jax(mesh_step_case):
    spec_j, pos, eps = mesh_step_case
    p_j, exc_j, cr_j, p_t, exc_t, cr_t = _compare_step(
        "mesh", pos, spec_j, _port_spec(spec_j), eps, jax.random.PRNGKey(4),
        mesh=True)
    npt.assert_array_equal(exc_t, exc_j)
    npt.assert_array_equal(cr_t, 0)
    npt.assert_array_equal(cr_j, 0)
    npt.assert_allclose(p_t, p_j, rtol=0, atol=1e-5)
    # The case bounces: some spins end off their straight-line step.
    directions, _ = _fed_draws(jax.random.PRNGKey(4), N_STEP, mesh=True)
    off = np.linalg.norm(p_t - (pos + directions.numpy()), axis=0) > 1e-4
    assert off.sum() > 20


def test_permeable_mesh_step_crossing_rate(mesh_step_case):
    spec_j, pos, eps = mesh_step_case
    spec_j = jspecs.MeshSpec(**{
        **{k: getattr(spec_j, k) for k in (*MESH_FIELDS, "n_sv", "spans",
                                           "chunk")},
        "perm_prob": jnp.asarray(0.5, jnp.float32)})
    crossings = {}
    for seed in range(3):
        _, _, cr_j, _, _, cr_t = _compare_step(
            "mesh", pos, spec_j, _port_spec(spec_j), eps,
            jax.random.PRNGKey(20 + seed), mesh=True)
        crossings[seed] = (int(cr_j.sum()), int(cr_t.sum()))
    total_j = sum(c[0] for c in crossings.values())
    total_t = sum(c[1] for c in crossings.values())
    # Both engines cross at perm 0.5 of their collisions; the first pass
    # draws are shared, the later ones are not. Binomial spread: well
    # inside 4 sigma of each other.
    assert total_j > 40, crossings
    assert abs(total_t - total_j) <= 4 * np.sqrt(total_j), crossings


# ---------------------------------------------------------------------------
# (e) Samplers.
# ---------------------------------------------------------------------------


def test_samplers_equal_jax():
    R = np.linalg.qr(np.random.RandomState(0).standard_normal((3, 3)))[0]
    cases = (
        ("_fill_sphere", (500, 5e-6)),
        ("_fill_circle", (500, 3e-6)),
        ("_fill_ellipsoid", (500, np.array([5e-6, 3e-6, 2e-6]))),
        ("_initial_positions_cylinder", (500, 3e-6, R)),
        ("_initial_positions_ellipsoid", (500, np.array([5e-6, 3e-6, 2e-6]),
                                          R)),
    )
    for name, args in cases:
        np.random.seed(17)
        ours = getattr(simulations, name)(*args)
        np.random.seed(17)
        npt.assert_array_equal(ours, getattr(jsim, name)(*args), err_msg=name)


# ---------------------------------------------------------------------------
# (f) Through simulation(device="cpu").
# ---------------------------------------------------------------------------


def _example_gradient(n_t):
    gradient = np.zeros((1, 100, 3))
    gradient[0, 1:11, 0] = 1
    gradient[0, -11:-1, 0] = -1
    gradient, dt = gradients.interpolate_gradient(gradient, 80e-3 / 99, n_t)
    bs = np.linspace(1, 3e9, 4)
    gradient = np.concatenate([gradient for _ in bs], axis=0)
    return gradients.set_b(gradient, dt, bs), dt


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_analytic_substrates_confined_with_trajectories(tmp_path, dtype):
    n_s, n_t = 100, 100
    gradient, dt = _example_gradient(n_t)
    step_l = np.sqrt(6 * D * dt)
    radius = 5e-6
    R = np.linalg.qr(np.random.RandomState(2).standard_normal((3, 3)))[0]
    cases = (
        (substrates.sphere(radius), lambda p: np.linalg.norm(p, axis=-1)),
        (substrates.cylinder(radius, np.array([1.0, 0, 0])),
         lambda p: np.linalg.norm(p[..., 1:], axis=-1)),
        (substrates.ellipsoid(np.ones(3) * radius),
         lambda p: np.linalg.norm(p, axis=-1)),
        # Equal semiaxes under a rotation: a sphere seen in a turned frame.
        (substrates.ellipsoid(np.ones(3) * radius, R),
         lambda p: np.linalg.norm(p, axis=-1)),
    )
    out = []
    for sub, radial in cases:
        traj = str(tmp_path / "traj.txt")
        s, pos = simulations.simulation(
            n_s, D, gradient, dt, sub, traj=traj, final_pos=True, quiet=True,
            dtype=dtype, device="cpu")
        trajectories = np.loadtxt(traj)
        assert trajectories.shape == (n_t + 1, 3 * n_s)
        trajectories = trajectories.reshape((n_t + 1, n_s, 3))
        # The file holds the lab-frame positions; its last row is final_pos
        # to the file's print precision.
        npt.assert_allclose(trajectories[-1], pos, rtol=1e-7, atol=1e-16)
        max_pos = radial(trajectories).max()
        # float32 tangential grazes overshoot by up to ~1e-4 step lengths
        # (the JAX package's confinement bound is 1e-2 step lengths).
        assert max_pos < radius + 1e-2 * step_l
        assert max_pos > radius * 0.95
        assert np.all(np.isfinite(s)) and np.all(np.abs(s) <= n_s)
        out.append((s, pos))
    # Sphere and equal-semiaxes ellipsoid: same seed, same initial
    # positions, same draws (the JAX package asserts 3 decimals).
    npt.assert_almost_equal(out[0][0] / n_s, out[2][0] / n_s, 3)
    # The rotated ellipsoid is the sphere driven by the waveform turned
    # into its frame, with positions turned back out: equal up to the
    # rounding of the turned waveform and positions (float32: 1e-5 step
    # lengths, a few ulps grown by grazing bounces).
    s_rot, pos_rot = simulations.simulation(
        n_s, D, gradient @ R, dt, substrates.sphere(radius), final_pos=True,
        quiet=True, dtype=dtype, device="cpu")
    npt.assert_allclose(out[3][0], s_rot, rtol=0, atol=1e-4 * n_s)
    tol = (1e-5 if dtype == "float32" else 1e-10) * step_l
    npt.assert_allclose(out[3][1], pos_rot @ R.T, rtol=0, atol=tol)


def test_cylinder_orientation_sign_is_canonical():
    gradient, dt = _example_gradient(50)
    out = [
        simulations.simulation(
            300, D, gradient, dt,
            substrates.cylinder(5e-6, sign * np.array([1.0, 0, 1.0])),
            quiet=True, device="cpu")
        for sign in (1, -1)
    ]
    npt.assert_array_equal(out[0], out[1])


def _cylinder_mesh(oracles_dir, **kw):
    with open(oracles_dir / "cylinder_mesh_closed.pkl", "rb") as f:
        mesh = pickle.load(f)
    return substrates.mesh(mesh["vertices"], mesh["faces"], True,
                           padding=np.zeros(3), n_sv=np.array([10, 10, 10]),
                           quiet=True, **kw)


def _classic_used(sub):
    return any(k[0] == "classic-torch" for k in sub._accel_cache)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_classic_mesh_trajectories_and_confinement(oracles_dir, tmp_path,
                                                   dtype):
    n_s, n_t = 100, 60
    gradient, dt = _example_gradient(n_t)
    sub = _cylinder_mesh(oracles_dir, init_pos="intra")
    traj = str(tmp_path / "traj.txt")
    s, pos = simulations.simulation(
        n_s, D, gradient, dt, sub, traj=traj, final_pos=True, quiet=True,
        dtype=dtype, device="cpu")
    assert _classic_used(sub)
    trajectories = np.loadtxt(traj).reshape((n_t + 1, n_s, 3))
    npt.assert_almost_equal(trajectories[-1], pos, 8)
    centre = np.max(sub.vertices, axis=0)[0:2] / 2
    r = np.max(np.linalg.norm(sub.vertices[:, 0:2] - sub.voxel_size[0:2] / 2,
                              axis=1))
    radial = np.linalg.norm(trajectories[..., 0:2] - centre, axis=-1)
    assert radial.max() < r
    assert trajectories[..., 2].min() > 0
    assert trajectories[..., 2].max() < sub.voxel_size[2]
    assert np.all(np.isfinite(s))


def test_fused_handovers_run_classic(oracles_dir):
    """Meshes the fused engine cannot serve run through the classic one."""
    gradient = np.zeros((2, 20, 3))
    gradient[1, 2:8, 0], gradient[1, 12:18, 0] = 0.05, -0.05
    ok = dict(diffusivity=D, gradient=gradient, quiet=True, device="cpu")
    # Effective epsilon above the fused table's drift budget; use_fused =
    # False; steps five voxels long (no fused configuration fits; the halo
    # row then holds every triangle in ~340 periodic images, so the case
    # stays small on the CPU).
    for kw in (dict(n_walkers=64, epsilon=1e-7, dt=1e-4),
               dict(n_walkers=64, dt=1e-4),
               dict(n_walkers=8, dt=0.2, gradient=gradient[:, :3])):
        sub = _cylinder_mesh(oracles_dir)
        try:
            config.use_fused = False if "epsilon" not in kw and kw["dt"] < 0.1 else None
            s = simulations.simulation(substrate=sub, **{**ok, **kw})
        finally:
            config.use_fused = None
        assert _classic_used(sub), kw
        n = kw["n_walkers"]
        assert np.all(np.isfinite(s)) and np.all(np.abs(s) <= n)
        npt.assert_allclose(s[0], n)  # no gradient: no dephasing


def _pr1_free_window(positions, phases, g_eff, ts, seed32):
    """The free-diffusion loop as the port ran it before the classic
    engine took it over."""
    ids = torch.arange(positions.shape[1], dtype=torch.int32)
    seed_k = int(seed32) ^ core.FREE_SALT
    for i, t in enumerate(ts):
        positions = positions + krng.unit_directions(
            seed_k, int(t), ids, positions.dtype)
        phases = phases + g_eff[i] @ positions
    return positions, phases


def test_free_diffusion_bitwise_unchanged():
    gradient, dt = _example_gradient(80)
    n = 1000
    signals, pos = simulations.simulation(
        n, D, gradient, dt, substrates.free(), seed=9, final_pos=True,
        quiet=True, device="cpu")
    step_l = np.sqrt(6 * D * dt)
    g_eff = torch.as_tensor(
        (gradients.GAMMA * dt * step_l) * np.transpose(gradient, (1, 0, 2)),
        dtype=torch.float32)
    p, ph = _pr1_free_window(torch.zeros((3, n)), torch.zeros((4, n)), g_eff,
                             range(80), 9)
    npt.assert_array_equal(signals, torch.cos(ph).sum(dim=1).numpy()
                           .astype(float))
    npt.assert_array_equal(pos, p.numpy().astype(float).T * step_l)
    # Free diffusion in float64 runs too.
    s64 = simulations.simulation(n, D, gradient, dt, substrates.free(),
                                 seed=9, quiet=True, device="cpu",
                                 dtype="float64")
    npt.assert_allclose(s64, signals, rtol=0, atol=1e-3 * n)


def test_free_trajectories_format(tmp_path):
    n_s, n_t = 50, 40
    gradient, dt = _example_gradient(n_t)
    traj = str(tmp_path / "traj.txt")
    _, pos = simulations.simulation(n_s, D, gradient, dt, substrates.free(),
                                    traj=traj, final_pos=True, quiet=True,
                                    device="cpu")
    trajectories = np.loadtxt(traj)
    assert trajectories.shape == (n_t + 1, 3 * n_s)
    trajectories = trajectories.reshape((n_t + 1, n_s, 3))
    npt.assert_array_equal(trajectories[0], 0.0)
    npt.assert_allclose(trajectories[-1], pos, rtol=1e-7, atol=1e-16)
    # Each row moves every spin by one step length.
    step_l = np.sqrt(6 * D * dt)
    hops = np.linalg.norm(np.diff(trajectories, axis=0), axis=2)
    npt.assert_allclose(hops, step_l, rtol=1e-5)


def test_run_window_rejects_tracking():
    # Tracking runs (tests/test_torch_exchange.py); a malformed request for
    # it is a ValueError, as simulation()'s malformed arguments are.
    args = ("free", specs.FreeSpec(), torch.zeros((3, 2)),
            torch.zeros((1, 2)), torch.zeros(2, dtype=torch.bool),
            torch.zeros((1, 1, 3)), range(1), 0, 1e-6, 10)
    comp = (torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.bool),
            torch.zeros(2, dtype=torch.int32))
    for bad in (dict(track="exchange"), dict(track="exchange",
                                             compartments=comp[:2]),
                dict(track="dwell", compartments=comp), dict(track=True)):
        with pytest.raises(ValueError):
            core.run_window(*args, **bad)
    _, _, (crossings, parity, intra) = core.run_window(
        *args, track="exchange", compartments=comp)
    assert crossings.tolist() == [0, 0] and intra.tolist() == [0, 0]
    assert not parity.any()


def test_geometry_row_and_column_layouts_agree():
    rng = np.random.RandomState(0)
    n = 64
    r0 = torch.tensor(rng.standard_normal((n, 3)))
    step = geometry.normalize(torch.tensor(rng.standard_normal((n, 3))))
    normal = geometry.normalize(torch.tensor(rng.standard_normal((n, 3))))
    d = torch.tensor(rng.random_sample(n))
    r_a, s_a = geometry.reflect(r0, step, d, normal, 1e-3)
    r_b, s_b = geometry.reflect_rows(r0.T, step.T, d, normal.T, 1e-3)
    npt.assert_allclose(r_a.numpy(), r_b.T.numpy(), atol=1e-12)
    npt.assert_allclose(s_a.numpy(), s_b.T.numpy(), atol=1e-12)
    npt.assert_allclose(
        geometry.crossing(r0, step, d, normal, 1e-3).numpy(),
        geometry.crossing_rows(r0.T, step.T, d, normal.T, 1e-3).T.numpy(),
        atol=1e-12)
    # Reflection keeps unit length and mirrors the normal component.
    npt.assert_allclose(np.linalg.norm(s_a.numpy(), axis=1), 1.0, atol=1e-12)
