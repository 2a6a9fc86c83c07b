"""Time the classic step kernels of the checkout this script sits in, and
fingerprint their outputs, so that two checkouts can be compared on one
card.

    python3 scripts/classic_step_ab.py run OUT.json
    python3 scripts/classic_step_ab.py compare A.json B.json ...

``run`` (one CUDA GPU) builds the checkout's kernels, then, on inputs drawn
from fixed seeds on the card:

- K8 (``analytic_kernel.analytic_step``) on the sphere, cylinder and
  ellipsoid x float32 / float64 x perm 0 / 0.5 at 524,288 spins, and on the
  sphere and cylinder at the analytic MISST runs' shape (1e5 spins, r = 5
  um at the 30 ms protocol's step, float32): device ms per launch, the
  median of five replays of a graph of 20 launches;
- the mesh step (``mesh_kernel.mesh_step``) on the bench bundle's halo pack,
  float32 / float64 x perm 0 / 0.5 at 524,288 spins: the same, and each of
  its kernels' device ms per step (torch.profiler over five steps);
- a sha256 of every output (positions, exc, crossings);
- the graphed sphere MISST run (30 ms, 1e5 x 1000 x 100 b) and the classic
  bench bundle (float32, 524,288 x 150 x 32) through ``simulation()``: the
  median wall of five runs and one torch.profiler run each (busy share,
  the kernels' device time).

``compare`` prints the files' times side by side and whether each output's
hash is the same in all of them. Run parent, change, change, parent in one
call: two calls may land on cards with other power limits.
"""

import dataclasses
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N = 524288
N_MISST = 100000
READINGS = 5


def _digest(out):
    h = hashlib.sha256()
    for t in out:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _graph_ms(fn):
    import chip_smoke

    return float(np.median([chip_smoke._graph_ms(fn, 20)
                            for _ in range(READINGS)]))


def _profile(fn, reps=1):
    """torch.profiler over ``reps`` calls of ``fn``: ({kernel name: (device
    ms, launches)} per call, device busy ms per call, wall ms per call)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            name = _short(e.name)
            ms, c = kernels.get(name, (0.0, 0))
            kernels[name] = (ms + e.self_device_time_total / 1e3, c + 1)
    busy = sum(ms for ms, _ in kernels.values())
    return ({k: (ms / reps, c / reps) for k, (ms, c) in sorted(
        kernels.items(), key=lambda kv: -kv[1][0])}, busy / reps,
        wall / reps)


def _short(name):
    """A kernel's name without its return type, namespace and arguments."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0][:60]


def _analytic_inputs(n, dtype, gen):
    ball = torch.randn((3, n), generator=gen, device="cuda", dtype=dtype)
    return ball / ball.norm(dim=0) * torch.rand(
        n, generator=gen, device="cuda", dtype=dtype) ** (1 / 3)


def step_kernels(parts=("k8", "mesh")):
    """K8 and the mesh step on fixed inputs (``parts``): times and output
    hashes."""
    import chip_smoke
    from disimpy_tpu_torch import simulations
    from disimpy_tpu_torch.engine import (analytic_kernel, draw_kernel,
                                          mesh_kernel, specs)

    scal = draw_kernel.device_scalars((4321, 17), "cuda")
    records = {}
    gen = torch.Generator(device="cuda").manual_seed(11)
    cases = []
    for dtype in (torch.float32, torch.float64):
        ball = _analytic_inputs(N, dtype, gen)
        eps = 64 * float(torch.finfo(dtype).eps) * 3.0
        for kind in ("sphere", "cylinder", "ellipsoid"):
            for perm in (0.0, 0.5):
                p = torch.tensor(perm, dtype=dtype, device="cuda")
                if kind == "ellipsoid":
                    ax = torch.tensor([3.0, 2.5, 2.0], dtype=dtype,
                                      device="cuda")
                    spec, pos = specs.EllipsoidSpec(ax, p), ball * ax[:, None]
                else:
                    r = torch.tensor(3.0, dtype=dtype, device="cuda")
                    spec = (specs.SphereSpec if kind == "sphere"
                            else specs.CylinderSpec)(r, p)
                    pos = ball * 3.0
                cases.append((f"K8 {kind} {str(dtype)[6:]} perm {perm}",
                              kind, spec, pos.contiguous(), eps))
    _, dt = chip_smoke._misst_gradient(30, 1000)
    scale = 1.0 / float(np.sqrt(6 * chip_smoke.DIFFUSIVITY * dt))
    r = 5e-6 * scale
    ball = _analytic_inputs(N_MISST, torch.float32, gen)
    for kind, cls in (("sphere", specs.SphereSpec),
                      ("cylinder", specs.CylinderSpec)):
        eps = simulations._effective_epsilon(1e-13, scale, r, 1000,
                                             torch.float32, kind == "sphere")
        cases.append((f"K8 {kind} float32 MISST shape", kind, cls(
            torch.tensor(r, device="cuda"), torch.tensor(0.0, device="cuda")),
            (ball * r).contiguous(), eps))
    for label, kind, spec, pos, eps in cases if "k8" in parts else ():
        ids = torch.arange(pos.shape[1], dtype=torch.int32, device="cuda")

        def k8(kind=kind, spec=spec, pos=pos, eps=eps, ids=ids):
            return analytic_kernel.analytic_step(kind, pos, spec, eps, 1000,
                                                 scal[0], scal[1], ids)
        records[label] = dict(ms=_graph_ms(k8), hash=_digest(k8()))
        print(label, records[label], flush=True)

    if "mesh" not in parts:
        return records
    sub, _, _ = chip_smoke._bundle_substrate()
    scale = 1.0 / chip_smoke.BUNDLE_STEP
    gen = torch.Generator(device="cuda").manual_seed(12)
    ids = torch.arange(N, dtype=torch.int32, device="cuda")
    for dtype in (torch.float32, torch.float64):
        spec0 = simulations._classic_mesh_spec(sub, scale, dtype,
                                               torch.device("cuda"))
        pos = (torch.rand((3, N), generator=gen, device="cuda", dtype=dtype)
               * spec0.voxel_size[:, None])
        eps = simulations._effective_epsilon(
            1e-13, scale, float(np.max(sub.voxel_size)) * scale, 150, dtype,
            False)
        for perm in (0.0, 0.5):
            spec = dataclasses.replace(spec0, perm_prob=torch.tensor(
                perm, dtype=dtype, device="cuda"))

            def step(spec=spec, pos=pos, eps=eps):
                return mesh_kernel.mesh_step(spec, pos, eps, 1000, scal[0],
                                             scal[1], ids)
            label = f"mesh step bundle {str(dtype)[6:]} perm {perm}"
            step()
            records[label] = dict(ms=_graph_ms(step), hash=_digest(step()),
                                  kernels=_profile(step, 5)[0])
            print(label, records[label], flush=True)
    return records


def runs():
    """The graphed sphere MISST run and the classic bench bundle: median
    wall of five, and one profiled run each."""
    import chip_smoke
    from disimpy_tpu_torch import gradients, simulations, substrates
    from disimpy_tpu_torch.engine import config

    sub, _, _ = chip_smoke._bundle_substrate()
    gradient_b, _ = gradients.pgse(
        1e-3, chip_smoke.BUNDLE_DT * 150 - 1e-3, 150, np.linspace(1e8, 3e9, 32),
        np.tile([[1.0, 0.0, 0.0]], (32, 1)))
    gradient_m, dt_m = chip_smoke._misst_gradient(30, 1000)
    out = {}
    for label, sim in (
            ("sphere MISST 30 ms, 1e5 x 1000 x 100 b", lambda seed:
             simulations.simulation(N_MISST, chip_smoke.DIFFUSIVITY,
                                    gradient_m, dt_m,
                                    substrates.sphere(5e-6), seed=seed,
                                    quiet=True, device="cuda")),
            ("classic bundle float32, 524288 x 150 x 32", lambda seed:
             simulations.simulation(N, chip_smoke.DIFFUSIVITY, gradient_b,
                                    chip_smoke.BUNDLE_DT, sub, seed=seed,
                                    quiet=True, device="cuda"))):
        config.use_fused = False
        try:
            sim(1)
            walls = []
            for _ in range(READINGS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = sim(2)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            kernels, busy, wall = _profile(lambda: sim(2))
        finally:
            config.use_fused = None
        out[label] = dict(walls=walls, median=float(np.median(walls)),
                          busy=busy / wall, hash=_digest(
                              (torch.as_tensor(res),)), kernels=kernels)
        print(label, out[label], flush=True)
    return out


def run(path):
    import chip_smoke

    smi = chip_smoke.card()
    result = dict(card=smi, tree=REPO, steps=step_kernels(), runs=runs())
    with open(path, "w") as f:
        json.dump(result, f, indent=1)


def compare(paths):
    data = [json.load(open(p)) for p in paths]
    print("card:", data[0]["card"])
    for key in ("steps", "runs"):
        for label in data[0][key]:
            recs = [d[key].get(label, {}) for d in data]
            hashes = {r.get("hash") for r in recs}
            unit = "ms" if key == "steps" else "s"
            times = " / ".join(
                f"{r.get('ms', r.get('median', float('nan'))):.4f}"
                for r in recs)
            same = "same outputs" if len(hashes) == 1 else "OUTPUTS DIFFER"
            print(f"{label}: {times} {unit} ({same})")
            for r, p in zip(recs, paths):
                if "kernels" in r:
                    print(f"    {p}: " + ", ".join(
                        f"{k} {ms:.4f} x {c:g}"
                        for k, (ms, c) in list(r["kernels"].items())[:12]))


if __name__ == "__main__":
    if sys.argv[1:2] == ["run"] and len(sys.argv) == 3:
        run(sys.argv[2])
    elif sys.argv[1:2] == ["compare"] and len(sys.argv) > 3:
        compare(sys.argv[2:])
    else:
        sys.exit(__doc__)
