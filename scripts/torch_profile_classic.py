"""Where a classic-engine bench run of the PyTorch port spends its time,
and the fused engine's run beside it.

Runs the bench bundle (bench.py's workload: 102,400 triangles, 524,288
spins x 150 steps x 32 measurements) through
``disimpy_tpu_torch.simulations.simulation(device="cuda")`` with
``config.use_fused = False``: three unprofiled warm runs, then one run
under ``torch.profiler``; then the same through the fused engine (two
unprofiled runs, one profiled). Prints the walls, the kernel launches,
each kernel's summed device time (the nearest-hit query's four kernels
together, then the mesh step's later bounces and tail), the profiler's
table and the operators with the most device
time. Needs one CUDA GPU; run from the repository root:

    python3 scripts/torch_profile_classic.py
"""

import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from disimpy_tpu_torch import gradients, meshes, simulations, substrates  # noqa: E402
from disimpy_tpu_torch.engine import (  # noqa: E402
    config, launch_count)


# The kernels of one nearest-hit query (csrc/mesh_hit.cu), and those of a
# classic mesh step's later bounces and tail.
MESH_HIT_KERNELS = ("cell_pass", "scan_pass", "scatter_pass", "hit_pass")
MESH_BOUNCE_KERNELS = ("bounce_pass", "finish_pass")


def device_ms(event):
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0)) / 1e3


def main():
    smi = chip_smoke.card()
    dt, n = 1.3e-5, 524288
    step_l = float(np.sqrt(6 * chip_smoke.DIFFUSIVITY * dt))
    vertices, faces = meshes.cylinder_array_mesh(
        1.5e-6, 4e-6, grid=(8, 8), length=32e-6, n_facets=32, n_segments=25)
    n_sv = max(1, int(4e-6 * 8 / (4.2 * step_l)))
    sub = substrates.mesh(vertices, faces, periodic=True,
                          n_sv=np.array([n_sv] * 3), quiet=True)
    gradient, _ = gradients.pgse(1e-3, dt * 150 - 1e-3, 150,
                                 np.linspace(1e8, 3e9, 32),
                                 np.tile([[1.0, 0.0, 0.0]], (32, 1)))

    def run(seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        simulations.simulation(n, chip_smoke.DIFFUSIVITY, gradient, dt, sub,
                               seed=seed, quiet=True, device="cuda")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    config.use_fused = False
    try:
        walls = [run(seed) for seed in (1, 2, 3)]
        print(f"unprofiled walls {walls} s ({smi})", flush=True)
        launch_count.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = run(2)
    finally:
        config.use_fused = None
    print(f"profiled wall {wall} s, {launch_count.counts['mesh_hit']} "
          f"mesh_hit and {launch_count.counts['mesh_bounce']} mesh_bounce "
          "launches")
    report(prof.key_averages(), "mesh_hit", MESH_HIT_KERNELS)
    report(prof.key_averages(), "mesh_bounce", MESH_BOUNCE_KERNELS)

    # The same workload through the fused engine (the default path).
    walls = [run(seed) for seed in (1, 2)]
    print(f"fused engine: unprofiled walls {walls} s ({smi})", flush=True)
    launch_count.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run(2)
    print(f"fused engine: profiled wall {wall} s, "
          f"{launch_count.counts['fused_epoch']} fused_epoch launches")
    report(prof.key_averages(), "fused_epoch", ("fused_epoch_kernel",))


def report(table, name, kernels):
    """Print the profiler's sums and the device time of the kernels whose
    names contain one of ``kernels``."""
    total = sum(device_ms(e) for e in table)
    mine = [e for e in table if any(k in e.key for k in kernels)]
    print(f"sum of self device time {total:.1f} ms (an operator and the "
          f"kernel it launches both count); {name}: "
          f"{sum(device_ms(e) for e in mine):.1f} ms device in "
          + ", ".join(f"{e.key[:60]} x {e.count}" for e in mine))
    print(table.table(sort_by="self_cuda_time_total", row_limit=25))
    for e in sorted(table, key=device_ms, reverse=True)[:15]:
        print(f"{e.key[:60]:60s} count {e.count:7d} device "
              f"{device_ms(e):9.1f} ms cpu {e.self_cpu_time_total / 1e3:9.1f} ms")


if __name__ == "__main__":
    main()
