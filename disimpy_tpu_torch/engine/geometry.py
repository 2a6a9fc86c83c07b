"""Batched geometric primitives on torch tensors.

Only the ray/triangle test that mesh point seeding needs lives here; the
collision geometry of the fused engine is inside its kernel
(``engine/fused_kernel.py``). The operation order follows the JAX package's
``engine/geometry.py`` so that float32 results agree bit for bit on the CPU.
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


def ray_triangle_intersection(triangles, r0, step):
    """Moller-Trumbore signed ray/triangle intersection distance.

    Hits count for barycentric ``u, v`` in [0, 1] with no tolerance band:
    parity ray-casting (point seeding) would double-count shared edges in a
    widened band and flip the parity.

    Parameters
    ----------
    triangles : torch.Tensor
        Shape (..., 3, 3): triangle corner points.
    r0 : torch.Tensor
        Shape (..., 3): ray origins (broadcastable against triangles).
    step : torch.Tensor
        Shape (..., 3): ray directions; the returned distance is in units of
        ``|step|``.

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
    ok = (det != 0) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
    ok = ok & (u + v <= 1.0)
    return torch.where(ok, t, torch.full_like(t, float("nan")))
