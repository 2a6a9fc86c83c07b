"""What the classic step kernels' schedules rely on, pinned on the plain
step functions (CPU, no JAX).

K9 (``csrc/mesh_hit.cu``) takes a mesh step's second collision check grouped
by the halo cell of each spin's next segment, in whatever order its sort
leaves the spins, and carries the few spins that collide again through one
warp each; K8 (``csrc/analytic_step.cu``) takes every spin's first check in
one batch and queues the rest in its block. Both equal the plain loops bit
for bit only if a spin's result does not depend on the spins processed
beside it, on the pass it is processed in, or on the order of a pass:

- the plain mesh step gives every spin the same result under a permutation
  of the spins and on subsets of them (so other compacted passes);
- a spin's k-th collision check draws the uniform of bounce index k - 1,
  whatever pass serves it;
- the mesh step with K9's schedule written out in plain torch (the first
  pass, the listed spins sorted by next halo cell and checked cell by cell,
  the rest one spin at a time) equals the plain loop;
- the plain analytic step gives every spin the same result under a
  permutation and on subsets (K8's block queue).
"""

import numpy as np
import pytest
import torch

from disimpy_tpu_torch import meshes, substrates
from disimpy_tpu_torch.engine import mesh_accel, mesh_kernel, rng, specs
from disimpy_tpu_torch.engine import stepping

import torch_threads  # noqa: F401  (shares the cores among xdist workers)

STEP_L = float(np.sqrt(6 * 2e-9 * 8e-5))
SEED, T = 31, 5
EPS = 64 * float(np.finfo(np.float32).eps) * 8.0


@pytest.fixture(scope="module")
def shell():
    """An icosphere's halo pack and 2,048 spins within a step of its
    facets (float32, step-length units): most hit the wall, and more
    spins collide after the first pass than one compacted pass takes
    (``max(128, n // 8)``)."""
    vertices, faces = meshes.icosphere(radius=5e-6, subdivisions=2)
    sub = substrates.mesh(vertices, faces, True, n_sv=np.array([4, 4, 4]),
                          quiet=True)
    spec = mesh_accel.pack_mesh(sub, 1 / STEP_L, torch.float32)
    assert tuple(spec.spans) == (1, 1, 1)
    rs = np.random.RandomState(8)
    n = 2048
    shell = rs.standard_normal((n, 3))
    shell /= np.linalg.norm(shell, axis=1, keepdims=True)
    centre = vertices.mean(axis=0) / STEP_L
    pos = centre + (5e-6 / STEP_L) * rs.uniform(0.8, 0.95, (n, 1)) * shell
    return spec, torch.tensor(pos.T, dtype=torch.float32).contiguous()


def _with_perm(spec, perm):
    return specs.MeshSpec(**{**spec.__dict__,
                             "perm_prob": torch.tensor(perm)})


def _mesh_step(spec, pos, ids, max_iter=1000, record=None):
    """stepping.step_mesh on the krng draws of (SEED, T, ids); ``record``
    (a list) collects each uniform call's (spin ids, bounce indices)."""
    draw = rng.bounce_uniforms(SEED, T, ids, torch.float32)

    def uniform(bounce, idx=None):
        if record is not None:
            who = ids if idx is None else ids[idx]
            b = (torch.full_like(who, bounce) if isinstance(bounce, int)
                 else bounce.to(who.dtype))
            record.append((who.clone(), b.clone()))
        return draw(bounce, idx)

    return stepping.step_mesh(pos, spec, EPS, max_iter,
                              rng.step_directions(SEED, T, ids,
                                                  torch.float32), uniform)


def _assert_rows(got, want, cols):
    """``got`` equals the columns ``cols`` of ``want``: positions, exc,
    crossings, bit for bit."""
    assert torch.equal(got[0], want[0][:, cols])
    assert torch.equal(got[1], want[1][cols])
    assert torch.equal(got[2], want[2][cols])


@pytest.mark.parametrize("perm", [0.0, 0.5])
def test_mesh_step_ignores_order_and_grouping(shell, perm):
    spec, pos = shell
    spec = _with_perm(spec, perm)
    n = pos.shape[1]
    ids = torch.arange(1000, 1000 + n, dtype=torch.int32)
    record = []
    full = _mesh_step(spec, pos, ids, record=record)
    # More spins collided after the first pass than one pass takes, so
    # some second checks waited for a later pass.
    assert len(record[1][0]) == max(128, n // 8)
    assert any(bool((b < p).any()) for p, (_, b) in enumerate(record))
    order = torch.from_numpy(np.random.RandomState(1).permutation(n))
    _assert_rows(_mesh_step(spec, pos[:, order].contiguous(), ids[order]),
                 full, order)
    # Subsets small enough to run each later check in one pass.
    for part in torch.tensor_split(order, 5):
        _assert_rows(_mesh_step(spec, pos[:, part].contiguous(), ids[part]),
                     full, part)
    assert int(full[2].sum()) > 0 or perm == 0.0


@pytest.mark.parametrize("perm", [0.0, 0.5])
def test_kth_check_draws_bounce_k_minus_1_in_any_pass(shell, perm):
    spec, pos = shell
    spec = _with_perm(spec, perm)
    n = pos.shape[1]
    ids = torch.arange(n, dtype=torch.int32)
    record = []
    _, exc, _ = _mesh_step(spec, pos, ids, record=record)
    drawn = [[] for _ in range(n)]
    late = 0
    for p, (who, bounce) in enumerate(record):
        for i, b in zip(who.tolist(), bounce.tolist()):
            drawn[i].append(b)
            late += p > b  # check b + 1 served by a later pass
    # Each spin drew bounce indices 0, 1, ..., one per check, in order.
    assert all(d == list(range(len(d))) for d in drawn)
    assert late > 0
    assert not bool(exc.any())


@pytest.mark.parametrize("max_iter", [1000, 3])
@pytest.mark.parametrize("perm", [0.0, 0.5])
def test_cell_grouped_schedule_equals_the_plain_loop(shell, perm, max_iter):
    """K9's schedule in plain torch: the first pass on every spin; the
    listed spins sorted by the halo cell of their next segment, the second
    check one cell at a time; the rest one spin at a time to the end."""
    spec, pos = shell
    spec = _with_perm(spec, perm)
    n = pos.shape[1]
    ids = torch.arange(n, dtype=torch.int32)
    want = _mesh_step(spec, pos, ids, max_iter)

    query = stepping._make_mesh_query(spec, torch.float32, pos.device)
    slack = stepping._hit_slack(torch.float32)
    uniform = rng.bounce_uniforms(SEED, T, ids, torch.float32)
    r0 = pos.T.contiguous()
    direction = rng.step_directions(SEED, T, ids, torch.float32).T
    rem = torch.ones(n)
    iters = torch.zeros(n, dtype=torch.int32)
    crossings = torch.zeros(n, dtype=torch.int32)

    def check(idx):
        """One collision check of the spins ``idx``; returns those that
        still collide."""
        it = iters[idx] + 1
        d, normal = query(r0[idx], direction[idx], rem[idx])
        hit = d <= rem[idx] + slack
        r0_s, dir_s, rem_s, crossed = stepping._resolve_mesh_hits(
            spec, r0[idx], direction[idx], rem[idx], d, normal, hit,
            uniform(it - 1, idx), EPS)
        r0[idx], direction[idx], rem[idx] = r0_s, dir_s, rem_s
        iters[idx] = it
        crossings[idx] += crossed.to(torch.int32)
        return idx[hit & (rem_s > 0) & (it < max_iter)]

    listed = check(torch.arange(n))
    cell, _ = mesh_kernel.halo_cells(spec, r0[listed], direction[listed],
                                     rem[listed])
    rest = []
    groups = 0
    for c in torch.unique(cell):
        rest.append(check(listed[cell == c]))
        groups += 1
    rest = torch.cat(rest)
    assert groups > 1 and 0 < len(rest) < len(listed)
    for i in rest.tolist():
        one = torch.tensor([i])
        while len(check(one)):
            pass
    got = ((r0 + direction * rem[:, None]).T, iters >= max_iter, crossings)
    _assert_rows(got, want, torch.arange(n))
    assert bool(got[1].any()) == (max_iter == 3)


def _analytic(kind, perm, n=600, per_spin=False):
    """(spec, positions, epsilon): spins uniform in a compartment a few
    step lengths across, float32."""
    rs = np.random.RandomState(6)
    ball = rs.standard_normal((n, 3))
    ball = ball / np.linalg.norm(ball, axis=1, keepdims=True) * rs.uniform(
        0, 1, (n, 1)) ** (1 / 3)
    p = torch.tensor(perm)
    radius = (torch.from_numpy(rs.uniform(2.4, 3.6, n)).float() if per_spin
              else torch.tensor(3.0))
    r = radius.numpy()[:, None] if per_spin else 3.0
    if kind == "sphere":
        spec, pos = specs.SphereSpec(radius, p), ball * r
    elif kind == "cylinder":
        spec, pos = specs.CylinderSpec(radius, p), ball * r * np.array(
            [2.0, 1.0, 1.0])
    else:
        ax = np.array([3.0, 2.5, 2.0])
        spec, pos = specs.EllipsoidSpec(torch.tensor(ax).float(), p), ball * ax
    return spec, torch.tensor(pos.T, dtype=torch.float32).contiguous()


def _sub_spec(spec, part):
    """``spec`` for the spins ``part`` (a per-spin radius follows them)."""
    if getattr(spec, "radius", None) is not None and spec.radius.ndim:
        return type(spec)(spec.radius[part], spec.perm_prob)
    return spec


@pytest.mark.parametrize("perm", [0.0, 0.5])
@pytest.mark.parametrize("kind,per_spin", [
    ("sphere", False), ("sphere", True), ("cylinder", False),
    ("cylinder", True), ("ellipsoid", False)])
def test_analytic_step_ignores_the_batch(kind, per_spin, perm):
    spec, pos = _analytic(kind, perm, per_spin=per_spin)
    n = pos.shape[1]
    ids = torch.arange(500, 500 + n, dtype=torch.int32)
    full = stepping.plain_step(kind, pos, spec, EPS, 1000, SEED, T, ids)
    assert int((full[2] > 0).sum()) > 0 or perm == 0.0
    order = torch.from_numpy(np.random.RandomState(2).permutation(n))
    for part in [order] + list(torch.tensor_split(order, 7)):
        got = stepping.plain_step(kind, pos[:, part].contiguous(),
                                  _sub_spec(spec, part), EPS, 1000, SEED, T,
                                  ids[part])
        _assert_rows(got, full, part)
