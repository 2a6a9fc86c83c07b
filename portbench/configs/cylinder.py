"""The reference project's open-ended mesh cylinder: vertices, faces and the
substrate's arguments. ``cylinder_mesh.npz`` holds the mesh of its
``cylinder_mesh_open.pkl``: float64 vertices (m), int32 faces."""

from harness import meshfile


def build(sizes, traffic):
    """(vertices (m), faces, keyword arguments of ``substrates.mesh``)."""
    return meshfile.build(sizes, traffic["n_walkers"])
