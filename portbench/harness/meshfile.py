"""Meshes stored as data beside a configuration (plain NumPy).

A configuration whose geometry is a published mesh keeps it as
``configs/<file>.npz`` (``vertices`` in metres, ``faces``) with the
arguments its source gives ``substrates.mesh``: ``periodic``, and where
the source sets them ``padding``, ``n_sv`` and ``init_pos`` ("uniform", or
``{"point": [x, y, z]}``, every spin starting there, metres in the padded
voxel). The builder hands the same arrays to the program and to the
reference.
"""

import os

import numpy as np

CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


def build(sizes, n_walkers):
    """(vertices (m), faces, keyword arguments of ``substrates.mesh``)."""
    with np.load(os.path.join(CONFIG_DIR, sizes["mesh_file"])) as mesh:
        vertices = np.asarray(mesh["vertices"], dtype=np.float64)
        faces = np.asarray(mesh["faces"], dtype=np.int64)
    kwargs = {"periodic": sizes["periodic"], "init_pos": "uniform"}
    if "padding" in sizes:
        kwargs["padding"] = np.asarray(sizes["padding"], dtype=np.float64)
    if "n_sv" in sizes:
        kwargs["n_sv"] = np.asarray(sizes["n_sv"], dtype=np.int64)
    init = sizes.get("init_pos", "uniform")
    if isinstance(init, dict):
        init = np.zeros((n_walkers, 3)) + np.asarray(init["point"])
    kwargs["init_pos"] = init
    return vertices, faces, kwargs
