"""Substrate specs consumed by the classic stepping engine.

The engine works in *step-length units*: all geometry is rescaled by
``1 / step_l`` at setup so a time step always has length 1, which keeps
every coordinate O(1)-O(100) whatever the substrate's size.

Each spec is a plain frozen dataclass of tensors on one device, in the
engine dtype (float32 or float64); shape-determining fields (subvoxel
counts, traversal spans, chunk size) are Python values.
"""

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FreeSpec:
    """Free diffusion: no geometry."""


@dataclasses.dataclass(frozen=True)
class SphereSpec:
    """Sphere of ``radius`` (step-length units), centred at the origin.

    ``perm_prob`` is the probability of crossing the surface per collision.
    """

    radius: torch.Tensor
    perm_prob: torch.Tensor


@dataclasses.dataclass(frozen=True)
class CylinderSpec:
    """Infinite cylinder along +x of ``radius`` (step-length units).

    The engine simulates in the cylinder frame; the driver rotates the
    waveform into this frame and the positions back out.
    """

    radius: torch.Tensor
    perm_prob: torch.Tensor


@dataclasses.dataclass(frozen=True)
class EllipsoidSpec:
    """Axis-aligned ellipsoid with ``semiaxes`` (3,), in the ellipsoid frame."""

    semiaxes: torch.Tensor
    perm_prob: torch.Tensor


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Triangle mesh packed into its uniform-grid acceleration structure.

    Attributes
    ----------
    tri : torch.Tensor
        (n_subvoxels, n_chunks, chunk, 12) per-slot triangle records: 9
        corner coordinates (step-length units) followed by the unit normal.
        Subvoxel (x, y, z) is row ``x * n_sv[1] * n_sv[2] + y * n_sv[2] +
        z``; padding slots hold all-zero (degenerate) triangles that the
        intersection test rejects (det == 0).
    cell_counts : torch.Tensor
        (n_subvoxels,) int32: records in use at the start of each row.
    voxel_size : torch.Tensor
        (3,) voxel extent (step-length units); the periodic tile.
    sv_width : torch.Tensor
        (3,) subvoxel width per axis.
    perm_prob : torch.Tensor
        Scalar probability of passing through a triangle on collision.
    n_sv : tuple[int, int, int]
        Subvoxel counts.
    spans : tuple[int, int, int]
        Per-axis number of subvoxels a query scans; (1, 1, 1) for the halo
        layout (each row holds every triangle reachable from its cell).
    chunk : int
        Records per chunk of a row.
    """

    tri: torch.Tensor
    cell_counts: torch.Tensor
    voxel_size: torch.Tensor
    sv_width: torch.Tensor
    perm_prob: torch.Tensor
    n_sv: tuple
    spans: tuple
    chunk: int


_ANALYTIC = {
    "sphere": (SphereSpec, ("radius", "perm_prob")),
    "cylinder": (CylinderSpec, ("radius", "perm_prob")),
    "ellipsoid": (EllipsoidSpec, ("semiaxes", "perm_prob")),
}
_MESH_ARRAYS = ("tri", "cell_counts", "voxel_size", "sv_width", "perm_prob")


def spec_from_numpy(arrays, meta, device):
    """Build a spec on ``device`` from numpy arrays.

    ``meta["kind"]`` names the spec: "sphere", "cylinder", "ellipsoid" or
    "mesh". ``arrays`` maps the spec's array fields to numpy arrays (for
    example the fields of the JAX package's spec converted with
    ``np.asarray``); a mesh's ``meta`` also holds ``n_sv``, ``spans`` and
    ``chunk``. Float arrays keep their dtype (float32 or float64); a mesh's
    ``cell_counts`` becomes int32.
    """
    kind = meta["kind"]
    if kind == "mesh":
        cls, fields = MeshSpec, _MESH_ARRAYS
    elif kind in _ANALYTIC:
        cls, fields = _ANALYTIC[kind]
    else:
        raise ValueError(f"unknown spec kind {kind!r}")
    if set(arrays) != set(fields):
        raise ValueError(f"{kind} arrays must hold exactly {sorted(fields)}")
    tensors = {}
    for k in fields:
        a = np.asarray(arrays[k])
        dtype = torch.int32 if k == "cell_counts" else None
        tensors[k] = torch.tensor(a, dtype=dtype, device=device)
    if kind != "mesh":
        return cls(**tensors)
    if tensors["tri"].ndim != 4 or tensors["tri"].shape[3] != 12:
        raise ValueError("tri must have shape (cells, n_chunks, chunk, 12)")
    return cls(
        **tensors,
        n_sv=tuple(int(x) for x in meta["n_sv"]),
        spans=tuple(int(x) for x in meta["spans"]),
        chunk=int(meta["chunk"]),
    )
