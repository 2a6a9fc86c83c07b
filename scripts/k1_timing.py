"""K1's time per epoch, repeated within one process, on one CUDA GPU.

Times the epoch kernel's default and counting variants on the bench
bundle's pack at 524,288 sorted uniform spins (perm 0 and 0.5), as
``chip_smoke.py`` phase 3 does, four times over with 20 and 200 calls
each, then once through phase 3's comparison with the plain version and
once more after it; each line shows the card's clocks, power draw,
temperature and throttle reasons from nvidia-smi. It shows the spread of
phase 3's single reading:

    python3 scripts/k1_timing.py
"""
import os
import subprocess
import sys
from dataclasses import replace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from disimpy_tpu_torch.engine import fused_kernel  # noqa: E402
from disimpy_tpu_torch.simulations import _effective_epsilon  # noqa: E402


def clocks():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu,clocks_throttle_reasons.active",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def epoch_args(bench, perm, eps):
    spec = replace(bench["spec"], perm_prob=torch.tensor(perm, device="cuda"))
    inputs, seed_k = cs._sorted_epoch_inputs(spec, 524288, seed=11)
    return spec, (spec, *inputs, 0, spec.resort_every, seed_k, eps, 1000)


def main():
    cs.card()
    bench = cs.bench_setup()
    scale = 1.0 / bench["step_l"]
    eps = _effective_epsilon(
        1e-13, scale, float(np.max(bench["substrate"].voxel_size)) * scale,
        150, torch.float32, False)
    print("clocks idle:", clocks(), flush=True)
    for rep in range(4):
        for perm in (0.0, 0.5):
            _, args = epoch_args(bench, perm, eps)
            ms, _ = cs._cuda_ms(lambda: fused_kernel.fused_epoch(*args), 20)
            cms, _ = cs._cuda_ms(
                lambda: fused_kernel.fused_epoch(*args, count=True), 20)
            ms2, _ = cs._cuda_ms(lambda: fused_kernel.fused_epoch(*args), 200)
            print(f"rep {rep} perm {perm}: default {ms:.4f} ms (20 reps), "
                  f"{ms2:.4f} ms (200 reps); counting {cms:.4f} ms; "
                  f"{clocks()}", flush=True)
    spec, _ = epoch_args(bench, 0.0, eps)
    r = cs._epoch_vs_plain(spec, 524288, eps)
    print(f"_epoch_vs_plain perm 0: default {r['ms']:.4f} ms, counting "
          f"{r['count_ms']:.4f} ms, plain {r['plain_ms']:.1f} ms", flush=True)
    for perm in (0.0, 0.5):
        _, args = epoch_args(bench, perm, eps)
        ms, _ = cs._cuda_ms(lambda: fused_kernel.fused_epoch(*args), 20)
        print(f"after plain, perm {perm}: default {ms:.4f} ms; {clocks()}",
              flush=True)


if __name__ == "__main__":
    main()
