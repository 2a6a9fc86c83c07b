"""Engine selection, the fused engine's epoch length and cell width, and
the fused kernel's counting variant.

``use_fused``: None or True (use the fused-step mesh engine for float32
runs without trajectory output), or False (always use the classic
per-bounce engine).

``fused_resort_every``: epoch length J of the fused engine (steps between
spin re-sorts; the packed table's dilation depth), 1..``engine.fused.MAX_J``.
The epoch kernel folds each step's distance-ordered chunk prefix, so a
longer epoch amortizes the sort/back-permute without paying the full
last-step dilation on early steps. ``pack_fused`` lowers J when the
geometry is too dense for its dilation; the kernel runs the J it chose.

``fused_cell_steps``: grid cell width (in step lengths) for the fused
table, or None to let ``pack_fused`` search its width ladder. Wider cells
hold more units per row; narrower cells split each fold block's spins over
more rows (the cost model in ``fused.pack_fused``).

Both knobs key the substrate's fused-spec cache, so a flipped knob never
serves a stale table.

``fused_count_units``: when True, a single-part fused run launches the
counting variant of the epoch kernel and sums its counts into
``simulations._STREAM_DIAG`` (see that module). The walks are the same
bit for bit; the counts cost a little kernel time.

``fused_cuda_graph``: when True (the default), a fused window on a CUDA
device runs its full epochs as replays of one captured CUDA graph
(``engine/fused.run_window_fused``); False runs every epoch eagerly, the
same kernels launched from Python one by one, which gives the same values
bit for bit and serves to compare the two. CPU runs are always eager.

``classic_cuda_graph``: the same for the classic engine: when True (the
default), a classic window on a CUDA device runs every step as a replay of
one captured CUDA graph of ``engine/core.step_body``; False runs each step
eagerly. Both mesh layouts are graphed: neither's step reads anything back.
"""

use_fused = None
fused_resort_every = 4
fused_cell_steps = None
fused_count_units = False
fused_cuda_graph = True
classic_cuda_graph = True


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


def mesh_query_backend(spec, dtype, device):
    """Resolve the classic engine's nearest-hit query: "kernel" or "gather".

    "kernel" (``engine/mesh_kernel.py``: K2 for the halo layout, K10 for
    the per-cell layout) on a CUDA device, in float32 and float64;
    "gather" (``engine/mesh_accel.nearest_hit``) for every CPU tensor. The
    choice follows the device alone.
    """
    import torch

    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the mesh query runs in float32 or float64, not {dtype}")
    if torch.device(device).type == "cuda":
        return "kernel"
    return "gather"
