"""One time step per substrate kind: the classic per-bounce engine.

Each ``step_*`` function advances the whole ensemble by one time step of
unit length (the engine works in step-length units): take each spin's
direction, resolve surface collisions, and return the new positions, a
per-spin flag for spins that exhausted the collision-iteration budget, and
the per-spin membrane-crossing count.

Signature: ``step_fn(positions, spec, epsilon, max_iter, directions,
uniform)``. Positions and directions are (3, n) tensors; the draws come in
as arguments (see ``engine/rng.py``), so the same step runs on the
id-keyed streams or on another engine's draws.

These are the plain versions. The JAX package's masked ``lax.while_loop``
bounce loops become Python loops over torch ops that run until no spin is
still colliding; each pass reads one flag back from the device.

:func:`step` is what the classic window (``engine/core.py``) calls: it
draws from the id-keyed streams and, on a CUDA device, runs the step as
kernels with no host read-back: K8 (``engine/analytic_kernel.py``) for the
analytic substrates, the mesh step of ``engine/mesh_kernel.py`` for both
mesh layouts (K2's passes, then K9, on the halo layout; K10, its second
check, then K9's remainder over the stencil, on the per-cell layout). Free
diffusion is the draw kernel and one add.

``iter_exc`` semantics: a spin is flagged when it has entered the
collision check ``max_iter`` times, and the driver excludes flagged spins
from the signal.
"""

import torch

from . import analytic_kernel, config, geometry, mesh_accel, mesh_kernel, rng
from .specs import CylinderSpec, EllipsoidSpec, FreeSpec, MeshSpec, SphereSpec


def _make_mesh_query(spec, dtype, device):
    """``query(r0, direction, rem) -> (min_d, normal)`` on (n, 3) tensors.

    The CUDA kernels serve both layouts on the GPU; the gather query of
    ``mesh_accel`` serves every CPU tensor. The triangle test is widened
    by a barycentric tolerance scaled to the dtype's rounding error, so
    adjacent triangles overlap rather than gap.
    """
    if config.mesh_query_backend(spec, dtype, device) == "kernel":
        return lambda r0, direction, rem: mesh_kernel.nearest_hit(
            spec, r0.contiguous(), direction.contiguous(), rem.contiguous()
        )
    edge_tol = mesh_kernel.EDGE_TOL[dtype]
    return lambda r0, direction, rem: mesh_accel.nearest_hit(
        spec, r0, direction, rem, edge_tol=edge_tol
    )


def step_free(positions, spec: FreeSpec, epsilon, max_iter, directions,
              uniform):
    """Free diffusion: unit step, no collisions."""
    n = positions.shape[1]
    exc = torch.zeros(n, dtype=torch.bool, device=positions.device)
    crossings = torch.zeros(n, dtype=torch.int32, device=positions.device)
    return positions + directions, exc, crossings


def _hit_slack(dtype):
    """Collision-acceptance slack (step-length units).

    The computed hit distance carries the dtype's rounding error; when a
    step ends within that error of a surface, ``d`` can come out just past
    ``rem`` and the un-reflected final move penetrates the wall. Accepting
    hits up to ``rem + slack`` reflects such steps slightly early instead.
    """
    return 1e-5 if dtype == torch.float32 else 1e-12


def _smallest_positive_root(A, B, C, perm_prob, dtype):
    """Forward collision root of ``A d^2 + B d + C = 0`` (+inf when none).

    Impermeable compartment (``perm_prob == 0``): always the far root. A
    float32 tangential graze can strand a walker up to ~1e-2 step lengths
    outside the wall; the far root makes it traverse to the far wall and
    reflect back inside, where a near-root bounce would exile it.

    Permeable compartment: both roots compete and the nearest forward one
    wins (``A <= 0``, a direction parallel to a cylinder axis, means no
    intersection). The near root must clear the dtype's hit slack, so a
    walker sitting on the surface within rounding falls through to the far
    root.
    """
    disc = B * B - 4.0 * A * C
    ok = (disc >= 0) & (A > 0)
    sq = torch.sqrt(torch.where(ok, disc, torch.zeros_like(disc)))
    inv = 0.5 / torch.where(ok, A, torch.ones_like(A))
    r1 = (-B - sq) * inv  # r1 <= r2 since A > 0
    r2 = (-B + sq) * inv
    inf = torch.full_like(r2, float("inf"))
    far = torch.where(r2 > 0, r2, inf)
    near_first = torch.where(r1 > _hit_slack(dtype), r1, far)
    d = torch.where(perm_prob > 0, near_first, far)
    return torch.where(ok, d, inf)


def _bounce_analytic(positions, perm_prob, epsilon, max_iter, directions,
                     uniform, distance_and_normal):
    """Shared masked bounce loop for the analytic substrates.

    ``distance_and_normal(r0, direction) -> (d, normal)`` returns the (n,)
    distance to the surface along the direction (+inf when the ray misses)
    and a (3, n) surface normal at the hit point (either orientation).

    On each collision the walker crosses the surface with probability
    ``perm_prob`` (keeping its direction, offset ``epsilon`` past the wall)
    and reflects otherwise. The strict ``u < perm_prob`` makes 0 exactly
    impermeable. Every spin still active in a pass is at the same pass
    index, which keys its uniform.
    """
    n = positions.shape[1]
    dtype = positions.dtype
    device = positions.device
    slack = _hit_slack(dtype)
    r0 = positions
    direction = directions
    rem = torch.ones(n, dtype=dtype, device=device)
    iters = torch.zeros(n, dtype=torch.int32, device=device)
    active = torch.ones(n, dtype=torch.bool, device=device)
    crossings = torch.zeros(n, dtype=torch.int32, device=device)
    bounce = 0
    while bool(active.any()):
        iters = iters + active.to(torch.int32)
        d, normal = distance_and_normal(r0, direction)
        hit = active & (d > 0) & (d < rem + slack)
        go_through = uniform(bounce) < perm_prob
        refl_r0, refl_dir = geometry.reflect_rows(
            r0, direction, d, normal, epsilon
        )
        cross_r0 = geometry.crossing_rows(r0, direction, d, normal, epsilon)
        reflected = hit & ~go_through
        crossed = hit & go_through
        r0 = torch.where(
            reflected[None, :],
            refl_r0,
            torch.where(crossed[None, :], cross_r0, r0),
        )
        direction = torch.where(reflected[None, :], refl_dir, direction)
        rem = torch.where(hit, rem - (d + epsilon), rem)
        crossings = crossings + crossed.to(torch.int32)
        active = hit & (rem > 0) & (iters < max_iter)
        bounce += 1
    exc = iters >= max_iter
    return r0 + direction * rem[None, :], exc, crossings


def step_sphere(positions, spec: SphereSpec, epsilon, max_iter, directions,
                uniform):
    """Diffusion inside (or, with permeability, around) a sphere."""

    def distance_and_normal(r0, direction):
        B = 2.0 * geometry.dot_rows(direction, r0)
        C = geometry.dot_rows(r0, r0) - spec.radius**2
        d = _smallest_positive_root(
            torch.ones_like(B), B, C, spec.perm_prob, positions.dtype
        )
        normal = geometry.normalize_rows(-(r0 + d[None, :] * direction))
        return d, normal

    return _bounce_analytic(
        positions, spec.perm_prob, epsilon, max_iter, directions, uniform,
        distance_and_normal,
    )


def step_cylinder(positions, spec: CylinderSpec, epsilon, max_iter,
                  directions, uniform):
    """Diffusion inside an infinite cylinder along +x.

    Runs in the cylinder frame (the driver rotates the waveform and the
    outputs), so the collision test is a 2D circle test on y and z.
    """

    def distance_and_normal(r0, direction):
        ryz, dyz = r0[1:3], direction[1:3]
        A = torch.sum(dyz * dyz, dim=0)
        B = 2.0 * torch.sum(ryz * dyz, dim=0)
        C = torch.sum(ryz * ryz, dim=0) - spec.radius**2
        d = _smallest_positive_root(A, B, C, spec.perm_prob, positions.dtype)
        hit_yz = -(ryz + d[None, :] * dyz)
        normal = torch.cat(
            (torch.zeros((1, d.shape[0]), dtype=r0.dtype, device=r0.device),
             hit_yz)
        )
        return d, geometry.normalize_rows(normal)

    return _bounce_analytic(
        positions, spec.perm_prob, epsilon, max_iter, directions, uniform,
        distance_and_normal,
    )


def step_ellipsoid(positions, spec: EllipsoidSpec, epsilon, max_iter,
                   directions, uniform):
    """Diffusion inside an axis-aligned ellipsoid, in the ellipsoid frame."""

    def distance_and_normal(r0, direction):
        inv2 = (1.0 / (spec.semiaxes * spec.semiaxes))[:, None]
        A = torch.sum(direction * direction * inv2, dim=0)
        B = 2.0 * torch.sum(direction * r0 * inv2, dim=0)
        C = torch.sum(r0 * r0 * inv2, dim=0) - 1.0
        d = _smallest_positive_root(A, B, C, spec.perm_prob, positions.dtype)
        normal = -(r0 + d[None, :] * direction) * inv2
        return d, geometry.normalize_rows(normal)

    return _bounce_analytic(
        positions, spec.perm_prob, epsilon, max_iter, directions, uniform,
        distance_and_normal,
    )


def _resolve_mesh_hits(spec, r0, direction, rem, d, normal, hit, u, epsilon):
    """Apply reflect-or-cross to the spins flagged ``hit`` ((n, 3) layout,
    the mesh query's). Also returns the ``crossed`` mask (membrane
    transits). The strict ``u < perm_prob`` makes 0 exactly impermeable.
    """
    go_through = u < spec.perm_prob
    refl_r0, refl_dir = geometry.reflect(r0, direction, d, normal, epsilon)
    cross_r0 = geometry.crossing(r0, direction, d, normal, epsilon)
    reflected = hit & ~go_through
    crossed = hit & go_through
    r0 = torch.where(
        reflected[:, None], refl_r0,
        torch.where(crossed[:, None], cross_r0, r0),
    )
    direction = torch.where(reflected[:, None], refl_dir, direction)
    rem = torch.where(hit, rem - d, rem)
    return r0, direction, rem, crossed


def step_mesh(positions, spec: MeshSpec, epsilon, max_iter, directions,
              uniform):
    """Diffusion restricted by a triangle mesh.

    Per bounce: query the acceleration grid for the closest forward
    triangle hit within the remaining segment, then either reflect off it
    or (with probability ``perm_prob``) cross it.

    The first query runs on the whole ensemble (every spin needs it); later
    bounces concern only the spins that hit a wall, and run on at most
    ``capacity`` of the still-active spins at a time, gathered, resolved
    and scattered back. A spin's k-th collision draws its uniform at bounce
    index k, so neither the capacity nor the order of the compaction
    changes its stream.
    """
    n = positions.shape[1]
    dtype = positions.dtype
    device = positions.device
    slack = _hit_slack(dtype)
    query = _make_mesh_query(spec, dtype, device)
    direction = directions.T
    r0 = positions.T
    rem = torch.ones(n, dtype=dtype, device=device)

    # First pass: full-batch query and resolve.
    d, normal = query(r0, direction, rem)
    hit = d <= rem + slack
    r0, direction, rem, crossed = _resolve_mesh_hits(
        spec, r0, direction, rem, d, normal, hit, uniform(0), epsilon
    )
    crossings = crossed.to(torch.int32)
    iters = torch.ones(n, dtype=torch.int32, device=device)
    active = hit & (rem > 0) & (1 < max_iter)

    # Compacted bounce loop: retire up to `capacity` pending bounces per
    # pass; spins beyond capacity stay active for a later pass.
    capacity = min(n, max(128, n // 8))
    while True:
        idx = active.nonzero()[:capacity, 0]
        if idx.numel() == 0:
            break
        iters_s = iters[idx] + 1
        d, normal = query(r0[idx], direction[idx], rem[idx])
        hit = d <= rem[idx] + slack
        r0_s, dir_s, rem_s, crossed = _resolve_mesh_hits(
            spec, r0[idx], direction[idx], rem[idx], d, normal, hit,
            uniform(iters_s - 1, idx), epsilon,
        )
        r0[idx] = r0_s
        direction[idx] = dir_s
        rem[idx] = rem_s
        iters[idx] = iters_s
        crossings[idx] = crossings[idx] + crossed.to(torch.int32)
        active[idx] = hit & (rem_s > 0) & (iters_s < max_iter)
    exc = iters >= max_iter
    return (r0 + direction * rem[:, None]).T, exc, crossings


STEP_FUNCTIONS = {
    "free": step_free,
    "sphere": step_sphere,
    "cylinder": step_cylinder,
    "ellipsoid": step_ellipsoid,
    "mesh": step_mesh,
}


def step(kind, positions, spec, epsilon, max_iter, seed_k, t, ids):
    """One classic time step of ``kind`` with the id-keyed draws of step
    ``t`` (``seed_k`` and ``t`` Python ints or 0-d int32 tensors on the
    ids' device). Returns ``(positions (3, n), exc (n,), crossings (n,))``.

    On CUDA tensors the analytic substrates go to K8 and both mesh layouts
    to the mesh step kernels. CPU tensors and free diffusion run
    :func:`plain_step`.
    """
    if positions.is_cuda and kind in analytic_kernel.KINDS:
        return analytic_kernel.analytic_step(
            kind, positions, spec, epsilon, max_iter, seed_k, t, ids)
    if positions.is_cuda and kind == "mesh":
        return mesh_kernel.mesh_step(spec, positions, epsilon, max_iter,
                                     seed_k, t, ids)
    return plain_step(kind, positions, spec, epsilon, max_iter, seed_k, t,
                      ids)


def plain_step(kind, positions, spec, epsilon, max_iter, seed_k, t, ids):
    """:func:`step` as plain torch: ``STEP_FUNCTIONS[kind]`` fed the draws
    of ``engine/rng.py``. The step kernels' plain version."""
    dtype = positions.dtype
    return STEP_FUNCTIONS[kind](
        positions, spec, epsilon, max_iter,
        rng.step_directions(seed_k, t, ids, dtype),
        rng.bounce_uniforms(seed_k, t, ids, dtype),
    )
