"""Engine selection.

``use_fused``: None or True (use the fused-step mesh engine for float32
runs without trajectory output — the only mesh engine this package has so
far), or False (ask for the classic per-bounce engine, which raises
``NotImplementedError`` until it is ported).
"""

use_fused = None


def mesh_engine(dtype, needs_traj):
    """Resolve the mesh stepping engine: "fused" or "classic".

    The fused engine requires float32 and runs without per-step trajectory
    output; the classic engine covers the rest.
    """
    import torch

    if needs_traj or dtype != torch.float32:
        return "classic"
    if use_fused is False:
        return "classic"
    return "fused"
