"""Substrate objects: the simulated microstructure.

A substrate describes the geometry that restricts diffusion: free space, a
sphere, an infinite cylinder, an ellipsoid, or an arbitrary triangular mesh.
Mesh substrates are preprocessed at construction into a uniform-grid
acceleration structure ("subvoxels"): for every subvoxel, the indices of the
triangles overlapping it are stored in a CSR-like pair of index arrays. The
fused engine later re-packs it into distance-ordered per-cell rows (see
:func:`disimpy_tpu_torch.engine.fused.pack_fused`).

Behavior parity with the reference ``disimpy/substrates.py``: factory
validation (substrates.py:47-246), voxel construction (mesh: :249-257),
triangle/box overlap semantics (:290-368) and the subdivision output format
(:467-536, golden-tested against the reference's
``desired_triangle_indices.npy`` / ``desired_subvoxel_indices.npy``). The
implementation is vectorized NumPy (batched SAT tests over all candidate
pairs at once) rather than numba-jitted per-triangle loops.
"""

import numpy as np


class _Substrate:
    """Record describing the simulated microstructure.

    Attributes depend on ``type``:

    - ``"free"``: no attributes.
    - ``"sphere"``: ``radius``, ``perm_prob``.
    - ``"cylinder"``: ``radius``, ``orientation``, ``perm_prob``.
    - ``"ellipsoid"``: ``semiaxes``, ``R``, ``perm_prob``.
    - ``"mesh"``: ``vertices``, ``faces``, ``voxel_size``, ``periodic``,
      ``init_pos``, ``n_sv``, ``perm_prob``, plus the acceleration grid
      ``xs``, ``ys``, ``zs``, ``triangle_indices``, ``subvoxel_indices``.
    """

    def __init__(self, substrate_type, **kwargs):
        self.type = substrate_type
        if self.type == "sphere":
            self.radius = kwargs["radius"]
            self.perm_prob = kwargs.get("perm_prob", 0.0)
        elif self.type == "cylinder":
            self.radius = kwargs["radius"]
            self.orientation = kwargs["orientation"]
            self.perm_prob = kwargs.get("perm_prob", 0.0)
        elif self.type == "ellipsoid":
            self.semiaxes = kwargs["semiaxes"]
            self.R = kwargs["R"]
            self.perm_prob = kwargs.get("perm_prob", 0.0)
        elif self.type == "mesh":
            self.vertices = kwargs["vertices"]
            self.faces = kwargs["faces"]
            self.voxel_size = kwargs["voxel_size"]
            self.periodic = kwargs["periodic"]
            self.init_pos = kwargs["init_pos"]
            self.n_sv = kwargs["n_sv"]
            self.perm_prob = kwargs["perm_prob"]
            if not kwargs["quiet"]:
                print("Dividing the mesh into subvoxels")
            (
                self.xs,
                self.ys,
                self.zs,
                self.triangle_indices,
                self.subvoxel_indices,
            ) = _mesh_space_subdivision(
                self.vertices, self.faces, self.voxel_size, self.n_sv
            )
            if not kwargs["quiet"]:
                print("Finished dividing the mesh into subvoxels")
            # Engine-side packed representation, built lazily by the engine
            # the first time this substrate is simulated (cache slot).
            self._accel_cache = {}


def free():
    """Return a substrate object for simulating free diffusion.

    Returns
    -------
    substrate : disimpy_tpu_torch.substrates._Substrate
    """
    return _Substrate("free")


def _check_perm_prob(perm_prob):
    """Validate a permeability probability (same matrix as :func:`mesh`)."""
    if (
        (perm_prob != 0 and not isinstance(perm_prob, float))
        or perm_prob < 0
        or perm_prob > 1
    ):
        raise ValueError(f"Incorrect value ({perm_prob}) for perm_prob.")


def sphere(radius, perm_prob=0):
    """Return a substrate object for simulating diffusion inside a sphere.

    Parameters
    ----------
    radius : float
        Radius of the sphere (m).
    perm_prob : float, optional
        Probability of a walker passing through the surface on collision
        (TPU-native extension; the reference supports permeability only
        for mesh substrates, disimpy/substrates.py:151-246). Walkers that
        cross diffuse freely outside and can re-enter.

    Returns
    -------
    substrate : disimpy_tpu_torch.substrates._Substrate
    """
    if not isinstance(radius, float) or radius <= 0:
        raise ValueError(f"Incorrect value ({radius}) for radius")
    _check_perm_prob(perm_prob)
    return _Substrate("sphere", radius=radius, perm_prob=float(perm_prob))


def cylinder(radius, orientation, perm_prob=0):
    """Return a substrate object for diffusion inside an infinite cylinder.

    Parameters
    ----------
    radius : float
        Radius of the cylinder (m).
    orientation : numpy.ndarray
        Floating-point array of shape (3,) giving the cylinder axis
        direction (normalized internally).
    perm_prob : float, optional
        Probability of a walker passing through the surface on collision
        (TPU-native extension; see :func:`sphere`).

    Returns
    -------
    substrate : disimpy_tpu_torch.substrates._Substrate
    """
    if not isinstance(radius, float) or radius <= 0:
        raise ValueError(f"Incorrect value ({radius}) for radius")
    if (
        not isinstance(orientation, np.ndarray)
        or orientation.shape != (3,)
        or not np.issubdtype(orientation.dtype, np.floating)
    ):
        raise ValueError(f"Incorrect value ({orientation}) for orientation")
    _check_perm_prob(perm_prob)
    orientation = orientation / np.linalg.norm(orientation)
    return _Substrate(
        "cylinder", radius=radius, orientation=orientation,
        perm_prob=float(perm_prob),
    )


def ellipsoid(semiaxes, R=np.eye(3), perm_prob=0):
    """Return a substrate object for diffusion inside an ellipsoid.

    Parameters
    ----------
    semiaxes : numpy.ndarray
        Floating-point array of shape (3,) with the semi-axes of the
        axis-aligned ellipsoid (m).
    R : numpy.ndarray, optional
        3x3 rotation matrix applied to the axis-aligned ellipsoid
        (ellipsoid frame -> lab frame).
    perm_prob : float, optional
        Probability of a walker passing through the surface on collision
        (TPU-native extension; see :func:`sphere`).

    Returns
    -------
    substrate : disimpy_tpu_torch.substrates._Substrate
    """
    if (
        not isinstance(semiaxes, np.ndarray)
        or semiaxes.shape != (3,)
        or not np.issubdtype(semiaxes.dtype, np.floating)
    ):
        raise ValueError(f"Incorrect value ({semiaxes}) for semiaxes")
    if (
        not isinstance(R, np.ndarray)
        or R.shape != (3, 3)
        or not np.issubdtype(R.dtype, np.floating)
    ):
        raise ValueError(f"Incorrect value ({R}) for R")
    if not np.isclose(np.linalg.det(R), 1) or not np.all(
        np.isclose(R.T, np.linalg.inv(R))
    ):
        raise ValueError(f"R ({R}) is not a valid rotation matrix")
    _check_perm_prob(perm_prob)
    return _Substrate(
        "ellipsoid", semiaxes=semiaxes, R=R, perm_prob=float(perm_prob)
    )


def mesh(
    vertices,
    faces,
    periodic,
    padding=np.zeros(3),
    init_pos="uniform",
    n_sv=np.array([50, 50, 50]),
    quiet=False,
    perm_prob=0,
):
    """Return a substrate object for diffusion restricted by a triangle mesh.

    The simulated voxel is the axis-aligned bounding box of the triangles
    plus ``padding`` on both sides of each axis; the triangles are shifted so
    the lower corner of the voxel is at the origin.

    Parameters
    ----------
    vertices : numpy.ndarray
        Floating-point array of shape (number of vertices, 3).
    faces : numpy.ndarray
        Integer array of shape (number of triangles, 3): vertex indices of
        each triangle.
    periodic : bool
        If True, walkers leaving the voxel see periodically repeating copies
        of it. If False, the voxel boundary itself is added to the mesh as
        12 impermeable triangles.
    padding : numpy.ndarray, optional
        Floating-point array of shape (3,): empty space between the triangle
        bounding box and the voxel boundary on both sides of each axis.
    init_pos : numpy.ndarray or str, optional
        Either an array of shape (number of walkers, 3) of initial positions
        inside the voxel, or one of "uniform", "intra", "extra".
    n_sv : numpy.ndarray, optional
        Integer array of shape (3,): number of acceleration-grid subvoxels
        along each axis.
    quiet : bool, optional
        If True, do not print progress.
    perm_prob : float, optional
        Probability (in [0, 1]) that a walker passes through a triangle at a
        collision.

    Returns
    -------
    substrate : disimpy_tpu_torch.substrates._Substrate
    """
    if (
        not isinstance(vertices, np.ndarray)
        or vertices.ndim != 2
        or vertices.shape[1] != 3
        or not np.issubdtype(vertices.dtype, np.floating)
    ):
        raise ValueError(f"Incorrect value ({vertices}) for vertices.")
    if (
        not isinstance(faces, np.ndarray)
        or faces.ndim != 2
        or faces.shape[1] != 3
        or not np.issubdtype(faces.dtype, np.integer)
    ):
        raise ValueError(f"Incorrect value ({faces}) for faces.")
    if not isinstance(periodic, bool):
        raise ValueError(f"Incorrect value ({periodic}) for periodic")
    if (
        not isinstance(padding, np.ndarray)
        or padding.shape != (3,)
        or not np.issubdtype(padding.dtype, np.floating)
    ):
        raise ValueError(f"Incorrect value ({padding}) for padding")
    if isinstance(init_pos, np.ndarray):
        if (
            init_pos.ndim != 2
            or init_pos.shape[1] != 3
            or not np.issubdtype(init_pos.dtype, np.floating)
        ):
            raise ValueError(f"Incorrect value ({init_pos}) for init_pos")
    elif isinstance(init_pos, str):
        if init_pos not in ("uniform", "intra", "extra"):
            raise ValueError(f"Incorrect value ({init_pos}) for init_pos")
    else:
        raise ValueError(f"Incorrect value ({init_pos}) for init_pos")
    if (
        not isinstance(n_sv, np.ndarray)
        or n_sv.shape != (3,)
        or not np.issubdtype(n_sv.dtype, np.integer)
    ):
        raise ValueError(f"Incorrect value ({n_sv}) for n_sv")
    if (
        (perm_prob != 0 and not isinstance(perm_prob, float))
        or perm_prob < 0
        or perm_prob > 1
    ):
        raise ValueError(f"Incorrect value ({perm_prob}) for perm_prob.")
    if not quiet:
        print("Aligning the corner of the simulated voxel with the origin")
    shift = -np.min(vertices, axis=0) + padding
    vertices = vertices + shift
    if not quiet:
        print(f"Moved the vertices by {shift}")
    voxel_size = np.max(vertices, axis=0) + padding
    if not periodic:
        # A non-periodic voxel is bounded by impermeable walls: represent
        # them as 12 extra triangles so the collision kernel needs no
        # special casing (reference: substrates.py:254-257).
        voxel_vertices, voxel_faces = _aabb_to_mesh(np.zeros(3), voxel_size)
        faces = np.vstack((faces, voxel_faces + len(vertices)))
        vertices = np.vstack((vertices, voxel_vertices))
    return _Substrate(
        "mesh",
        vertices=vertices,
        faces=faces,
        voxel_size=voxel_size,
        n_sv=n_sv,
        periodic=periodic,
        init_pos=init_pos,
        quiet=quiet,
        perm_prob=perm_prob,
    )


# ---------------------------------------------------------------------------
# Vector helpers (explicit component arithmetic keeps the floating-point
# evaluation order identical to the reference's scalar code, which matters
# for exact golden-file parity of the subdivision output).
# ---------------------------------------------------------------------------


def _dot3(a, b):
    """Dot product over the last axis (length 3), broadcasting over the rest."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross3(a, b):
    """Cross product over the last axis (length 3), broadcasting over the rest."""
    return np.stack(
        (
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ),
        axis=-1,
    )


def _cross_product(a, b):
    """Cross product of two 1D arrays of length 3."""
    return _cross3(np.asarray(a, dtype=float), np.asarray(b, dtype=float))


def _dot_product(a, b):
    """Dot product of two 1D arrays of length 3."""
    return _dot3(np.asarray(a, dtype=float), np.asarray(b, dtype=float))


# The 8 box corners used by the plane-vs-corners test, as sign patterns of
# the half-extent vector, in the reference's order (substrates.py:335-346).
_CORNER_SIGNS = np.array(
    [
        [1, 1, 1],
        [-1, -1, -1],
        [-1, 1, 1],
        [1, -1, -1],
        [1, -1, 1],
        [-1, 1, -1],
        [1, 1, -1],
        [-1, -1, 1],
    ],
    dtype=float,
)


def _triangle_box_overlap_batch(triangles, boxes):
    """Vectorized triangle/AABB overlap test for N (triangle, box) pairs.

    Parameters
    ----------
    triangles : numpy.ndarray
        Array of shape (N, 3, 3): N triangles as three corner points.
    boxes : numpy.ndarray
        Array of shape (N, 2, 3): per pair, the box corners closest to and
        furthest from the origin.

    Returns
    -------
    numpy.ndarray
        Boolean array of shape (N,).

    Notes
    -----
    Implements the same sequence of separating-axis tests as the reference
    (substrates.py:290-368, after Akenine-Möller, "More Fast 3D Triangle-Box
    Overlap Testing"), including its exact accept/reject semantics:

    - the AABB pre-reject requires separation on *all* axes (not any), so it
      is weaker than a full AABB test;
    - the triangle-plane test is skipped when any box corner lies exactly in
      the triangle plane;
    - the 9 edge-cross-axis tests use strict inequalities.

    Golden-file parity with the reference's subdivision output depends on
    reproducing these choices exactly.
    """
    tri = np.asarray(triangles, dtype=float)
    box = np.asarray(boxes, dtype=float)
    c = (box[:, 0, :] + box[:, 1, :]) / 2.0
    h = np.abs(box[:, 1, :] - box[:, 0, :]) / 2.0
    v = tri - c[:, None, :]  # (N, 3, 3): triangle corners in box frame

    # Weak AABB pre-reject (all axes separated on the same side).
    tri_min = v.min(axis=1)
    tri_max = v.max(axis=1)
    rejected = np.all(tri_min > h, axis=1) | np.all(tri_max < -h, axis=1)

    # Triangle-plane vs box-corners test.
    f = np.stack(
        (
            v[:, 1, :] - v[:, 0, :],
            v[:, 2, :] - v[:, 1, :],
            v[:, 0, :] - v[:, 2, :],
        ),
        axis=1,
    )  # (N, 3, 3): edge vectors
    normal = _cross3(f[:, 0, :], f[:, 1, :])  # (N, 3)
    corners = _CORNER_SIGNS[None, :, :] * h[:, None, :]  # (N, 8, 3)
    dp = _dot3(normal[:, None, :], v[:, 0:1, :] - corners)  # (N, 8)
    in_plane = np.any(dp == 0, axis=1)
    behind = dp > 0
    plane_separated = np.all(behind, axis=1) | np.all(~behind, axis=1)
    rejected |= ~in_plane & plane_separated

    # 9 edge-cross-axis tests: axes e_i x f_j for unit axes e_i.
    for i in range(3):
        # cross(e_i, f_j) has a zero component along axis i; build it
        # directly to keep the arithmetic identical to the scalar code.
        a = np.zeros_like(f)  # (N, 3, 3): one axis per edge j
        i1, i2 = (i + 1) % 3, (i + 2) % 3
        a[:, :, i1] = -f[:, :, i2]
        a[:, :, i2] = f[:, :, i1]
        r = _dot3(h[:, None, :], np.abs(a))  # (N, 3)
        p = _dot3(a[:, :, None, :], v[:, None, :, :])  # (N, 3, 3): axis j, corner k
        rejected |= np.any((p.min(axis=2) > r) | (p.max(axis=2) < -r), axis=1)

    return ~rejected


def _triangle_box_overlap(triangle, box):
    """Check whether a triangle overlaps an axis-aligned box.

    Parameters
    ----------
    triangle : numpy.ndarray
        Array of shape (3, 3): the triangle's corner points.
    box : numpy.ndarray
        Array of shape (2, 3): the box corners closest to and furthest from
        the origin.

    Returns
    -------
    bool
    """
    return bool(
        _triangle_box_overlap_batch(
            np.asarray(triangle, dtype=float)[None], np.asarray(box, dtype=float)[None]
        )[0]
    )


def _interval_sv_overlap(xs, x1, x2):
    """Return the subvoxel index range overlapping the interval [x1, x2].

    Parameters
    ----------
    xs : numpy.ndarray
        Sorted subvoxel boundary positions along one axis.
    x1, x2 : float
        Interval endpoints (in either order).

    Returns
    -------
    ll, ul : int
        Lowest and highest overlapping subvoxel boundary indices; the
        overlapped subvoxels are ``range(ll, ul)``. The range is guaranteed
        non-empty (reference semantics, substrates.py:371-419).
    """
    ll, ul = _interval_sv_overlap_batch(
        np.asarray(xs, dtype=float), np.asarray([x1], dtype=float),
        np.asarray([x2], dtype=float),
    )
    return int(ll[0]), int(ul[0])


def _interval_sv_overlap_batch(xs, x1, x2):
    """Vectorized :func:`_interval_sv_overlap` over arrays of intervals."""
    xmin = np.minimum(x1, x2)
    xmax = np.maximum(x1, x2)
    m = len(xs)
    # Lower limit: index of the subvoxel containing xmin, clamped.
    ll = np.searchsorted(xs, xmin, side="right") - 1
    ll = np.where(xmin <= xs[0], 0, ll)
    ll = np.where(xmin >= xs[-1], m - 1, ll)
    # Upper limit: first boundary index not below xmax, clamped.
    ul = np.searchsorted(xs, xmax, side="left")
    ul = np.where(xmax >= xs[-1], m - 1, ul)
    ul = np.where(xmax <= xs[0], 0, ul)
    # Guarantee a non-empty range: widen upward if possible, else downward.
    degenerate = ll == ul
    ll = np.where(degenerate & (ll == m - 1), ll - 1, ll)
    ul = np.where(degenerate & (ul != m - 1), ul + 1, ul)
    return ll.astype(int), ul.astype(int)


def _triangle_aabb(triangle):
    """Axis-aligned bounding box of a triangle.

    Parameters
    ----------
    triangle : numpy.ndarray
        Array of shape (3, 3): the triangle's corner points.

    Returns
    -------
    numpy.ndarray
        Array of shape (2, 3): corners closest to and furthest from the
        origin.
    """
    triangle = np.asarray(triangle, dtype=float)
    return np.vstack((triangle.min(axis=0), triangle.max(axis=0)))


def _box_subvoxel_overlap(box, xs, ys, zs):
    """Subvoxel index ranges overlapped by a box along each axis.

    Parameters
    ----------
    box : numpy.ndarray
        Array of shape (2, 3): corners closest to and furthest from origin.
    xs, ys, zs : numpy.ndarray
        Subvoxel boundaries along each axis.

    Returns
    -------
    numpy.ndarray
        Integer array of shape (3, 2): per axis, (lowest, highest) boundary
        index; the overlapped subvoxels are ``range(low, high)``.
    """
    out = np.zeros((3, 2), dtype=np.int32)
    for i, axis_boundaries in enumerate((xs, ys, zs)):
        out[i] = _interval_sv_overlap(axis_boundaries, box[0, i], box[1, i])
    return out


def _mesh_space_subdivision(vertices, faces, voxel_size, n_sv):
    """Build the uniform-grid acceleration structure for a triangle mesh.

    The voxel ``[0, voxel_size]`` is divided into ``prod(n_sv)`` subvoxels.
    For each triangle, candidate subvoxels come from its AABB; candidates are
    confirmed with the exact triangle/box overlap test. The result is a
    CSR-like pair: a flat array of triangle indices plus, per subvoxel, the
    (start, end) range into it.

    Parameters
    ----------
    vertices : numpy.ndarray
        Floating-point array of shape (number of vertices, 3).
    faces : numpy.ndarray
        Integer array of shape (number of triangles, 3).
    voxel_size : numpy.ndarray
        Floating-point array of shape (3,).
    n_sv : numpy.ndarray
        Integer array of shape (3,): subvoxels along each axis.

    Returns
    -------
    xs, ys, zs : numpy.ndarray
        Subvoxel boundaries along each axis (length ``n_sv[i] + 1``).
    triangle_indices : numpy.ndarray
        1D integer array with the triangle indices of all subvoxels,
        subvoxel-major, ascending triangle index within each subvoxel.
    subvoxel_indices : numpy.ndarray
        Integer array of shape (prod(n_sv), 2): per subvoxel, the (start,
        end) slice into ``triangle_indices``. Subvoxel (x, y, z) is flat
        index ``x * n_sv[1] * n_sv[2] + y * n_sv[2] + z``.

    Notes
    -----
    Output-identical to the reference ``_mesh_space_subdivision``
    (substrates.py:467-536; golden-tested), but evaluated as one batched SAT
    pass over all (triangle, candidate subvoxel) pairs instead of nested
    per-triangle loops.
    """
    n_sv = np.asarray(n_sv).astype(int)
    xs = np.linspace(0, voxel_size[0], n_sv[0] + 1)
    ys = np.linspace(0, voxel_size[1], n_sv[1] + 1)
    zs = np.linspace(0, voxel_size[2], n_sv[2] + 1)
    n_subvoxels = int(np.prod(n_sv))
    triangles = np.asarray(vertices, dtype=float)[np.asarray(faces)]  # (N, 3, 3)
    n_tris = triangles.shape[0]

    if n_tris == 0:
        return (
            xs,
            ys,
            zs,
            np.array([], dtype=int),
            np.zeros((n_subvoxels, 2), dtype=int),
        )

    # Candidate subvoxel ranges per triangle from its AABB.
    tri_min = triangles.min(axis=1)
    tri_max = triangles.max(axis=1)
    lls = np.zeros((n_tris, 3), dtype=int)
    uls = np.zeros((n_tris, 3), dtype=int)
    for i, axis_boundaries in enumerate((xs, ys, zs)):
        lls[:, i], uls[:, i] = _interval_sv_overlap_batch(
            axis_boundaries, tri_min[:, i], tri_max[:, i]
        )

    # Enumerate all (triangle, candidate subvoxel) pairs, triangle-major so
    # that triangle indices ascend within each subvoxel after a stable sort.
    spans = uls - lls  # (N, 3), all >= 1 by construction
    counts = spans.prod(axis=1)
    total = int(counts.sum())
    pair_tri = np.repeat(np.arange(n_tris), counts)
    # Rank of each pair within its triangle's candidate block.
    offsets = np.concatenate(([0], np.cumsum(counts)[:-1]))
    rank = np.arange(total) - np.repeat(offsets, counts)
    span_y = spans[pair_tri, 1]
    span_z = spans[pair_tri, 2]
    cx = lls[pair_tri, 0] + rank // (span_y * span_z)
    cy = lls[pair_tri, 1] + (rank // span_z) % span_y
    cz = lls[pair_tri, 2] + rank % span_z

    # Exact overlap confirmation, one batched SAT pass.
    boxes = np.empty((total, 2, 3))
    boxes[:, 0, 0], boxes[:, 1, 0] = xs[cx], xs[cx + 1]
    boxes[:, 0, 1], boxes[:, 1, 1] = ys[cy], ys[cy + 1]
    boxes[:, 0, 2], boxes[:, 1, 2] = zs[cz], zs[cz + 1]
    keep = _triangle_box_overlap_batch(triangles[pair_tri], boxes)

    sv_flat = (cx * n_sv[1] * n_sv[2] + cy * n_sv[2] + cz)[keep]
    kept_tri = pair_tri[keep]
    order = np.argsort(sv_flat, kind="stable")
    triangle_indices = kept_tri[order].astype(int)
    sv_sorted = sv_flat[order]

    per_sv = np.bincount(sv_sorted, minlength=n_subvoxels)
    ends = np.cumsum(per_sv)
    subvoxel_indices = np.stack((ends - per_sv, ends), axis=1).astype(int)
    return xs, ys, zs, triangle_indices, subvoxel_indices


def _aabb_to_mesh(a, b):
    """Triangulate the axis-aligned box with corners ``a`` and ``b``.

    Returns the 8 vertices and 12 triangles covering the box surface, in the
    reference's ordering (substrates.py:539-570) so appended voxel-wall
    triangles land at identical indices.
    """
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    vertices = np.array(
        [
            [a[0], a[1], a[2]],
            [b[0], a[1], a[2]],
            [b[0], b[1], a[2]],
            [b[0], b[1], b[2]],
            [a[0], b[1], b[2]],
            [a[0], a[1], b[2]],
            [a[0], b[1], a[2]],
            [b[0], a[1], b[2]],
        ]
    )
    faces = np.array(
        [
            [0, 1, 2],
            [0, 6, 2],
            [5, 7, 3],
            [5, 4, 3],
            [1, 2, 3],
            [1, 7, 3],
            [0, 6, 4],
            [0, 5, 4],
            [0, 1, 7],
            [0, 5, 7],
            [6, 2, 3],
            [6, 4, 3],
        ]
    )
    return vertices, faces
