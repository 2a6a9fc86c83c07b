"""The reference project's neuron mesh: the program's substrate and the
plain reference's walk, both from ``neuron_mesh.npz``, the mesh of its
``neuron-model.pkl``: float32 vertices (m), int32 faces."""

from harness.meshfile import reference, substrate  # noqa: F401
