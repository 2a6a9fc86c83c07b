"""The reference project's neuron mesh: vertices, faces and the
substrate's arguments. ``neuron_mesh.npz`` holds the mesh of its
``neuron-model.pkl``: float32 vertices (m), int32 faces."""

from harness import meshfile


def build(sizes, traffic):
    """(vertices (m), faces, keyword arguments of ``substrates.mesh``)."""
    return meshfile.build(sizes, traffic["n_walkers"])
