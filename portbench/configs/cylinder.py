"""The reference project's open-ended mesh cylinder: the program's
substrate and the plain reference's walk, both from ``cylinder_mesh.npz``,
the mesh of its ``cylinder_mesh_open.pkl``: float64 vertices (m), int32
faces."""

from harness.meshfile import reference, substrate  # noqa: F401
