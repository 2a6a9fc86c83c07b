"""General utility functions: rotations and optional 3D visualization.

Parity with reference ``disimpy/utils.py`` (vec2vec_rotmat at utils.py:11-42,
show_traj at :45-78, show_mesh at :81-111). matplotlib is imported lazily so
the core simulator has no hard plotting dependency.
"""

import numpy as np


def vec2vec_rotmat(v, k):
    """Return the rotation matrix that rotates vector ``v`` onto vector ``k``.

    Parameters
    ----------
    v : numpy.ndarray
        1D array of length 3.
    k : numpy.ndarray
        1D array of length 3.

    Returns
    -------
    R : numpy.ndarray
        3x3 rotation matrix with ``R @ v/|v| = k/|k|``.

    Notes
    -----
    Rodrigues' rotation formula about ``v x k``. Degenerate cases follow the
    reference convention (disimpy/utils.py:29-33): parallel vectors return
    the identity, antiparallel vectors return ``-eye(3)`` (an improper
    "rotation", kept for behavior parity).
    """
    v = np.asarray(v, dtype=float)
    k = np.asarray(k, dtype=float)
    v = v / np.linalg.norm(v)
    k = k / np.linalg.norm(k)
    axis = np.cross(v, k)
    axis_norm = np.linalg.norm(axis)
    if axis_norm < np.finfo(float).eps:
        if np.linalg.norm(v - k) > np.linalg.norm(v):
            return -np.eye(3)
        return np.eye(3)
    axis = axis / axis_norm
    angle = np.arccos(np.dot(v, k))
    K = np.array(
        [
            [0.0, -axis[2], axis[1]],
            [axis[2], 0.0, -axis[0]],
            [-axis[1], axis[0], 0.0],
        ]
    )
    return np.eye(3) + np.sin(angle) * K + (1.0 - np.cos(angle)) * (K @ K)


def _axes3d(title=None):
    """Lazy-import matplotlib and hand back (plt, a labelled 3D axes)."""
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "matplotlib is required for visualization; install the 'viz' extra"
        ) from e
    fig, ax = plt.subplots(subplot_kw={"projection": "3d"})
    for name in "xyz":
        getattr(ax, f"set_{name}label")(name)
    ax.ticklabel_format(style="sci", scilimits=(0, 0))
    if title:
        ax.set_title(title)
    return plt, fig, ax


def show_traj(traj_file, max_walkers=None, show=True):
    """Plot random-walker trajectories saved in a trajectories file.

    All trajectories are rendered as one ``Line3DCollection`` (a single
    vectorized artist, not a per-walker plotting loop), coloured by walker
    index.

    Parameters
    ----------
    traj_file : str
        Path to a trajectories file: one line per time point, each line
        holding ``walker_1_x walker_1_y walker_1_z walker_2_x ...``.
    max_walkers : int, optional
        Draw only the first ``max_walkers`` trajectories (all by default).
    show : bool, optional
        If False, return the figure without calling ``plt.show()`` (useful
        for headless testing).

    Returns
    -------
    matplotlib.figure.Figure
    """
    from mpl_toolkits.mplot3d.art3d import Line3DCollection

    flat = np.loadtxt(traj_file, ndmin=2)
    walkers = flat.reshape(flat.shape[0], -1, 3).transpose(1, 0, 2)
    if max_walkers is not None:
        walkers = walkers[:max_walkers]
    plt, fig, ax = _axes3d()
    colors = plt.cm.viridis(np.linspace(0.0, 1.0, len(walkers)))
    ax.add_collection3d(
        Line3DCollection(walkers, colors=colors, linewidths=0.8, alpha=0.5)
    )
    lo = walkers.reshape(-1, 3).min(axis=0)
    hi = walkers.reshape(-1, 3).max(axis=0)
    pad = 0.05 * np.maximum(hi - lo, np.finfo(float).tiny)
    ax.set_xlim(lo[0] - pad[0], hi[0] + pad[0])
    ax.set_ylim(lo[1] - pad[1], hi[1] + pad[1])
    ax.set_zlim(lo[2] - pad[2], hi[2] + pad[2])
    fig.tight_layout()
    if show:  # pragma: no cover
        plt.show()
    return fig


def show_mesh(substrate, seed=123, show=True):
    """Visualize a mesh substrate's triangles.

    All faces are rendered as one ``Poly3DCollection`` with a per-face
    random colour array (a single vectorized artist, not one collection
    per triangle).

    Parameters
    ----------
    substrate : disimpy_tpu_torch.substrates._Substrate
        A substrate of type "mesh".
    seed : int, optional
        Seed for the random face colours.
    show : bool, optional
        If False, return the figure without calling ``plt.show()``.

    Returns
    -------
    matplotlib.figure.Figure
    """
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    triangles = np.asarray(substrate.vertices)[np.asarray(substrate.faces)]
    colors = np.random.default_rng(seed).random((len(triangles), 3))
    plt, fig, ax = _axes3d()
    faces = Poly3DCollection(
        triangles, facecolors=colors, edgecolors="none", alpha=0.5
    )
    ax.add_collection3d(faces)
    ax.set_xlim(0, substrate.voxel_size[0])
    ax.set_ylim(0, substrate.voxel_size[1])
    ax.set_zlim(0, substrate.voxel_size[2])
    fig.tight_layout()
    if show:  # pragma: no cover
        plt.show()
    return fig


def save_camino_traj(path, traj_file, dt):
    """Convert an ASCII trajectories file to a Camino-style trajfile.

    The input is the text format written by ``simulations.simulation``'s
    ``traj`` argument (one line per time point: ``x1 y1 z1 x2 y2 z2 ...``
    in metres). The output is the binary walker-trajectory layout consumed
    by Camino's ``datasynth`` (``trajfile``): big-endian, a header of three
    float64 values ``[duration_s, n_walkers, n_timepoints]`` followed, for
    each time point and walker, by one record ``[t_s (float64),
    walker_index (int32), x, y, z (float64, metres)]``.

    Parameters
    ----------
    path : str
        Output trajfile path.
    traj_file : str or numpy.ndarray
        ASCII trajectories file path, or an (n_timepoints, n_walkers, 3)
        position array in metres.
    dt : float
        Time-step duration (s).

    Returns
    -------
    n_written : int
        Number of records written (n_timepoints * n_walkers).
    """
    if isinstance(traj_file, np.ndarray):
        traj = np.asarray(traj_file, dtype=float)
        if traj.ndim != 3 or traj.shape[2] != 3:
            raise ValueError(
                "Incorrect trajectory array shape %s" % (traj.shape,)
            )
    else:
        flat = np.loadtxt(traj_file)
        if flat.ndim == 1:
            flat = flat[None, :]
        traj = flat.reshape(flat.shape[0], -1, 3)
    n_t, n_walkers, _ = traj.shape
    header = np.array(
        [(n_t - 1) * float(dt), float(n_walkers), float(n_t)], dtype=">f8"
    )
    record = np.dtype(
        [("t", ">f8"), ("index", ">i4"), ("pos", ">f8", (3,))]
    )
    records = np.empty(n_t * n_walkers, dtype=record)
    records["t"] = np.repeat(np.arange(n_t) * float(dt), n_walkers)
    records["index"] = np.tile(np.arange(n_walkers, dtype=np.int32), n_t)
    records["pos"] = traj.reshape(-1, 3)
    with open(path, "wb") as f:
        header.tofile(f)
        records.tofile(f)
    return n_t * n_walkers


def load_camino_traj(path):
    """Read a Camino-style trajfile written by :func:`save_camino_traj`.

    Returns
    -------
    traj : numpy.ndarray
        (n_timepoints, n_walkers, 3) positions in metres.
    dt : float
        Time-step duration (s).
    """
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype=">f8", count=3)
        duration, n_walkers, n_t = header
        n_walkers, n_t = int(n_walkers), int(n_t)
        record = np.dtype(
            [("t", ">f8"), ("index", ">i4"), ("pos", ">f8", (3,))]
        )
        records = np.fromfile(f, dtype=record, count=n_t * n_walkers)
    traj = np.empty((n_t, n_walkers, 3), dtype=float)
    traj[
        np.repeat(np.arange(n_t), n_walkers),
        records["index"].astype(int),
    ] = records["pos"]
    dt = duration / max(n_t - 1, 1)
    return traj, float(dt)
