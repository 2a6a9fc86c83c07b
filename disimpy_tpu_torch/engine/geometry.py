"""Batched geometric primitives on torch tensors.

Every function is vectorised over a leading batch of spins. Misses are
encoded as ``inf``/``nan`` distances and "do nothing" updates are selected
with ``torch.where`` by the callers. The operation order follows the JAX
package's ``engine/geometry.py`` so that float32 results agree bit for bit
on the CPU.
"""

import torch


def dot3(a, b):
    """Dot product over the last axis (length 3)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross3(a, b):
    """Cross product over the last axis (length 3)."""
    return torch.stack(
        (
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ),
        dim=-1,
    )


def normalize(v):
    """Scale vectors on the last axis to unit length."""
    return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def ray_triangle_intersection(triangles, r0, step, edge_tol=0.0):
    """Moller-Trumbore signed ray/triangle intersection distance.

    Parameters
    ----------
    triangles : torch.Tensor
        Shape (..., 3, 3): triangle corner points.
    r0 : torch.Tensor
        Shape (..., 3): ray origins (broadcastable against triangles).
    step : torch.Tensor
        Shape (..., 3): ray directions; the returned distance is in units of
        ``|step|``.
    edge_tol : float, optional
        Barycentric tolerance: hits with ``u, v in [-edge_tol,
        1 + edge_tol]`` count. The collision path uses a small positive
        tolerance so rounding cannot open a gap along shared triangle edges
        (a spin slipping between two adjacent triangles is a leak). Parity
        ray-casting (point seeding) uses 0: a widened band there would
        double-count shared edges and flip the parity.

    Returns
    -------
    torch.Tensor
        Signed distance ``t`` where the ray's supporting line crosses the
        triangle's interior (including behind the origin, t < 0), or NaN
        for a miss / degenerate (det = 0) configuration.
    """
    A = triangles[..., 0, :]
    B = triangles[..., 1, :]
    C = triangles[..., 2, :]
    T = r0 - A
    E1 = B - A
    E2 = C - A
    P = cross3(step, E2)
    Q = cross3(T, E1)
    det = dot3(P, E1)
    inv_det = 1.0 / det
    t = inv_det * dot3(Q, E2)
    u = inv_det * dot3(P, T)
    v = inv_det * dot3(Q, step)
    lo = -edge_tol
    hi = 1.0 + edge_tol
    ok = (det != 0) & (u >= lo) & (u <= hi) & (v >= lo) & (v <= hi)
    ok = ok & (u + v <= hi)
    return torch.where(ok, t, torch.full_like(t, float("nan")))


def reflect(r0, step, d, normal, epsilon):
    """Specular reflection of a step at a surface hit, (n, 3) layout.

    Orients ``normal`` against the incoming direction, mirrors the
    direction, and offsets the new origin ``epsilon`` off the surface along
    the oriented normal. Returns ``(r0, step)``; callers select which spins
    actually reflected.
    """
    d = d[..., None]
    intersection = r0 + d * step
    v = d * step
    dp = dot3(v, normal)[..., None]
    normal = torch.where(dp > 0, -normal, normal)
    dp = -torch.abs(dp)  # dot with the oriented normal
    new_step = normalize(v - 2.0 * dp * normal)
    new_r0 = intersection + epsilon * normal
    return new_r0, new_step


def crossing(r0, step, d, normal, epsilon):
    """Permeable crossing of a surface: move epsilon past the hit point.

    Orients ``normal`` along the incoming direction and places the walker
    ``epsilon`` past the intersection; the direction is unchanged.
    """
    d = d[..., None]
    intersection = r0 + d * step
    dp = dot3(d * step, normal)[..., None]
    normal = torch.where(dp < 0, -normal, normal)
    return intersection + epsilon * normal


# ---------------------------------------------------------------------------
# Row-layout variants: vectors as (3, n) tensors, the analytic engine's
# layout.
# ---------------------------------------------------------------------------


def dot_rows(a, b):
    """Dot product of (3, n) vector bundles -> (n,)."""
    return torch.sum(a * b, dim=0)


def normalize_rows(v):
    """Scale (3, n) columns to unit length."""
    return v / torch.sqrt(torch.sum(v * v, dim=0, keepdim=True))


def reflect_rows(r0, step, d, normal, epsilon):
    """Row-layout specular reflection (see :func:`reflect`).

    All vector arguments are (3, n); ``d`` is (n,). Returns updated
    ``(r0, step)`` as (3, n).
    """
    v = d[None, :] * step
    intersection = r0 + v
    dp = torch.sum(v * normal, dim=0, keepdim=True)
    normal = torch.where(dp > 0, -normal, normal)
    dp = -torch.abs(dp)
    new_step = normalize_rows(v - 2.0 * dp * normal)
    new_r0 = intersection + epsilon * normal
    return new_r0, new_step


def crossing_rows(r0, step, d, normal, epsilon):
    """Row-layout permeable crossing (see :func:`crossing`)."""
    v = d[None, :] * step
    intersection = r0 + v
    dp = torch.sum(v * normal, dim=0, keepdim=True)
    normal = torch.where(dp < 0, -normal, normal)
    return intersection + epsilon * normal
