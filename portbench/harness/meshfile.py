"""Meshes stored as data beside a configuration (plain NumPy).

A configuration whose geometry is a published mesh keeps it as
``configs/<file>.npz`` (``vertices`` in metres, ``faces``) with the
arguments its source gives ``substrates.mesh``: ``periodic``, and where
the source sets them ``padding``, ``n_sv`` and ``init_pos`` ("uniform", or
``{"point": [x, y, z]}``, every spin starting there, metres in the padded
voxel). ``substrate`` and ``reference`` are the two functions that a
mesh configuration's builder (``configs/<config>.py``) names: each builds
the same arrays from the file, the one for the program
(``substrates.mesh``), the other for the plain reference
(``reference.walk.simulate``, periodic impermeable meshes).
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


def substrate(sizes, traffic):
    """The program's substrate: ``substrates.mesh`` of the file."""
    from disimpy_tpu_torch import substrates

    vertices, faces, kwargs = build(sizes, traffic["n_walkers"])
    return substrates.mesh(vertices, faces, quiet=True, **kwargs)


def reference(sizes, traffic, seed, gradient, cfg_dtype, dtype, device, work,
              max_iter):
    """The plain reference's walk of one call (``walk.Walk``) on the same
    arrays."""
    from reference import walk

    vertices, faces, kwargs = build(sizes, traffic["n_walkers"])
    return walk.simulate(
        vertices, faces, traffic["n_walkers"], traffic["diffusivity"],
        gradient, traffic["dt"], seed, kwargs["init_pos"], traffic["engine"],
        cfg_dtype, dtype=dtype, device=device, max_iter=max_iter, work=work,
        padding=kwargs.get("padding", np.zeros(3)))
