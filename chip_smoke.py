"""Drive the PyTorch port's main path once on one CUDA GPU and check it.

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
the CUDA toolkit:

    python3 chip_smoke.py

Phases, one line each (any failure raises, so the exit code is non-zero):

1. the card (name and power limit from nvidia-smi), torch and CUDA
   versions, and the build of ``disimpy_tpu_torch/csrc/fused_epoch.cu``;
2. the kernel's device threefry against ``engine/krng.py``, bit for bit;
3. the epoch kernel against its plain torch version on the bench bundle's
   pack (J = 4, perm 0 and 0.5; 16,384 sorted spins with equal iter_exc
   and transit counts, then the main path's 524,288): at most 0.5% of the
   spins diverge (positions more than 1e-4 step lengths apart), and both
   times;
4. free diffusion through ``simulation()`` against exp(-bD) (<= 0.01);
5. the closed cylinder mesh through ``simulation()`` against the vendored
   MISST signal (<= 0.015), with the leak checks of the JAX package's test;
6. the bench workload (102,400-triangle periodic bundle, 524,288 spins x
   150 steps x 32 measurements, uniform seeding) through ``simulation()``:
   pack time and static prefixes, a warm-up and a timed run, kernel
   launches per run, finite signals, at most 1e-4 of the spins changing
   compartment, and every such spin replayed: its crossing must be
   reproduced by the plain version from the kernel's states, or lie where
   two cylinders touch across the periodic boundary.

The line before the last holds the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA GPU, or without the rest
of the repository beside it, the script fails before printing either.
"""

import json
import math
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
ORACLES = os.path.join(REPO, "tests", "oracles")
DIFFUSIVITY = 2e-9
# Largest share of the bench run's spins that may change compartment: the
# reference algorithm lets ~2e-5 through, mostly where the bundle's
# cylinders touch across the periodic boundary (ROADMAP.md section 3).
MAX_CHANGED = 1e-4


def say(msg):
    print(msg, flush=True)


def card():
    """Phase 1: the card, the software, and the kernel build."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch finds no CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say(smi)
    say(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
        f"CUDA {torch.version.cuda}; devices {torch.cuda.device_count()}")
    from disimpy_tpu_torch.engine import _build

    built = _build.load("fused_epoch")
    regs = [ln.strip() for ln in built.log.splitlines()
            if "registers" in ln or "spill" in ln]
    say(f"build: csrc/fused_epoch.cu in {built.seconds:.2f} s -> "
        f"{os.path.relpath(built.path, REPO)}; ptxas: {' | '.join(regs)}")
    return smi


def threefry_check():
    """Phase 2: the device threefry equals the torch krng bit for bit."""
    from disimpy_tpu_torch.engine import fused_kernel, krng

    rng = np.random.RandomState(7)
    n = 10**6
    x0 = torch.from_numpy(
        rng.randint(-2**31, 2**31, size=n, dtype=np.int64).astype(np.int32)
    ).cuda()
    x1 = torch.from_numpy(
        rng.randint(-2**31, 2**31, size=n, dtype=np.int64).astype(np.int32)
    ).cuda()
    keys = [(0, 0), (123, 7), (-1, -5), (2**31 - 1, -2**31), (-2**31, 3)]
    for k0, k1 in keys:
        for rounds in (13, 20):
            dev = fused_kernel.threefry2x32_cuda(k0, k1, x0, x1, rounds)
            ref = krng.threefry2x32(k0, k1, x0, x1, rounds)
            torch.cuda.synchronize()
            for a, b in zip(dev, ref):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"device threefry differs for key {(k0, k1)}, "
                        f"{rounds} rounds"
                    )
    say(f"threefry: device words bitwise equal to krng on {n} counters x "
        f"{len(keys)} keys (incl. negative int32) x 13/20 rounds")


def bench_setup():
    """The bench bundle (bench.py's workload) and its pack, with the static
    prefix sizes the JAX package's pack gives (BENCH_r05.json tail)."""
    from disimpy_tpu_torch import gradients, meshes, substrates
    from disimpy_tpu_torch.engine import fused

    dt = 1.3e-5
    step_l = float(np.sqrt(6 * DIFFUSIVITY * dt))
    radius, spacing, grid = 1.5e-6, 4e-6, (8, 8)
    vertices, faces = meshes.cylinder_array_mesh(
        radius, spacing, grid=grid, length=32e-6, n_facets=32, n_segments=25
    )
    n_sv = max(1, int(spacing * grid[0] / (4.2 * step_l)))
    t0 = time.perf_counter()
    substrate = substrates.mesh(
        vertices, faces, periodic=True, n_sv=np.array([n_sv] * 3), quiet=True
    )
    t_sub = time.perf_counter() - t0
    t0 = time.perf_counter()
    spec = fused.pack_fused(
        substrate, 1.0 / step_l, resort_every=4, n_hint=524288.0,
        device="cuda",
    )
    t_pack = time.perf_counter() - t0
    packed = spec.cell_packed.cpu().numpy()
    pts = np.random.RandomState(0).random_sample((20000, 3)) * np.asarray(
        substrate.voxel_size) / step_l
    cell = np.minimum((pts / spec.sv_width.cpu().numpy()).astype(int),
                      np.array(spec.n_sv) - 1)
    flat = (cell[:, 0] * spec.n_sv[1] + cell[:, 1]) * spec.n_sv[2] + cell[:, 2]
    prefix = [
        round(float(((packed[flat] >> (fused.BITS * s)) & 63).mean()
                    * fused.UNIT_TRIS), 1)
        for s in range(spec.resort_every)
    ]
    say(f"bench pack: {len(faces)} triangles, substrate {t_sub:.1f} s, "
        f"pack_fused {t_pack:.1f} s host (disk cache may serve it), "
        f"J={spec.resort_every}, n_sv={spec.n_sv}, table "
        f"{spec.table.numel() * 4 / 1e6:.1f} MB; static prefix tris/spin "
        f"per epoch step: {prefix}")
    if prefix != [222.2, 373.4, 554.8, 956.8]:
        raise AssertionError(f"static prefixes {prefix} differ from the "
                             "JAX pack's 222.2/373.4/554.8/956.8")
    bvals = np.linspace(1e8, 3e9, 32)
    bvecs = np.tile(np.array([[1.0, 0.0, 0.0]]), (32, 1))
    gradient, _ = gradients.pgse(1e-3, dt * 150 - 1e-3, 150, bvals, bvecs)
    return dict(substrate=substrate, spec=spec, step_l=step_l, dt=dt,
                gradient=gradient, vertices=vertices, radius=radius,
                spacing=spacing, grid=grid)


def _sorted_epoch_inputs(spec, n, seed):
    """Epoch-sorted kernel inputs for n spins uniform in the voxel, built
    as the epoch driver builds them."""
    from disimpy_tpu_torch.engine import fused

    g = torch.Generator(device="cuda").manual_seed(seed)
    pos = torch.rand((3, n), generator=g, device="cuda") * spec.voxel_size[:, None]
    ids = torch.arange(n, dtype=torch.int32, device="cuda")
    seed_k = seed ^ spec.seed_salt
    _, _, inputs = fused.epoch_inputs(spec, pos, ids, 0, seed_k)
    return inputs, seed_k


def _cuda_ms(fn, reps):
    """Device time of ``fn()`` in ms: the mean over ``reps`` calls after a
    warm-up call, or the one call's own time when ``reps`` is 1 (no
    warm-up). Returns (ms, the last call's result)."""
    if reps > 1:
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(reps):
        out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, out


def kernel_vs_plain(bench):
    """Phase 3: the kernel against its plain version on the bench pack,
    at 16,384 sorted spins and at the main path's 524,288.

    At 16,384 spins iter_exc and the transit counts must be equal. At the
    full size a spin whose iter_exc or transit count differs counts as
    divergent, as does one whose positions differ by more than 1e-4 step
    lengths; at both sizes at most 0.5% of the spins may diverge.
    """
    from dataclasses import replace

    from disimpy_tpu_torch.engine import fused_kernel
    from disimpy_tpu_torch.simulations import _effective_epsilon

    base = bench["spec"]
    J = base.resort_every
    scale = 1.0 / bench["step_l"]
    eps = _effective_epsilon(
        1e-13, scale, float(np.max(bench["substrate"].voxel_size)) * scale,
        150, torch.float32, False)
    record = {}
    for n in (16384, 524288):
        for perm in (0.0, 0.5):
            spec = replace(base, perm_prob=torch.tensor(perm, device="cuda"))
            inputs, seed_k = _sorted_epoch_inputs(spec, n, seed=11)
            args = (spec, *inputs, 0, J, seed_k, eps, 1000)
            ms, (kp, ke, kc) = _cuda_ms(
                lambda: fused_kernel.fused_epoch(*args), 20)
            plain_ms, (pp, pe, pc) = _cuda_ms(
                lambda: fused_kernel.fused_epoch_reference(*args), 1)
            err = (kp - pp).abs().amax(dim=(0, 1))
            counts_differ = (ke != pe) | (kc != pc).any(dim=0)
            if n == 16384 and bool(counts_differ.any()):
                raise AssertionError(
                    f"perm {perm}: iter_exc or transit counts differ")
            frac_div = float(((err > 1e-4) | counts_differ).float().mean())
            max_err = float(err.max())
            if frac_div > 0.005:
                raise AssertionError(
                    f"perm {perm}: {frac_div:.4%} of {n} spins diverge")
            say(f"kernel vs plain, perm {perm}: {n} spins x J={J}; "
                f"{int(counts_differ.sum())} spins with other iter_exc or "
                f"transits (kernel {int(kc.sum())}, plain {int(pc.sum())}); "
                f"divergent fraction {frac_div:.6f}; max |err| {max_err:.3g} "
                f"step lengths; kernel {ms:.4f} ms, plain {plain_ms:.2f} ms "
                "per epoch")
            record[n, perm] = dict(max_abs_err=max_err, ms=ms,
                                   plain_ms=plain_ms, divergent=frac_div)
    return record


def free_oracle():
    """Phase 4: free diffusion against exp(-bD)."""
    from disimpy_tpu_torch import gradients, simulations, substrates

    bvals = np.linspace(1, 3e9, 16)
    bvecs = np.tile([[1.0, 0.0, 0.0]], (16, 1))
    gradient, dt = gradients.pgse(20e-3, 40e-3, 1000, bvals, bvecs)
    n = 100000
    s = simulations.simulation(n, DIFFUSIVITY, gradient, dt,
                               substrates.free(), quiet=True, device="cuda")
    err = float(np.abs(s / n - np.exp(-bvals * DIFFUSIVITY)).max())
    say(f"free diffusion: {n} spins x 1000 steps, max |S/n - exp(-bD)| = "
        f"{err:.5f} (limit 0.01)")
    if not err <= 0.01:
        raise AssertionError("free diffusion misses exp(-bD)")


def misst_oracle():
    """Phase 5: the closed cylinder mesh against the MISST signal."""
    from disimpy_tpu_torch import gradients, simulations, substrates

    with open(os.path.join(ORACLES, "cylinder_mesh_closed.pkl"), "rb") as f:
        mesh = pickle.load(f)
    bs = np.linspace(1, 3e9, 100)
    T, n0, lobe = 70e-3, 700, 300
    gradient = np.zeros((1, n0, 3))
    gradient[0, 1:lobe, 0] = 1
    gradient[0, -lobe:-1, 0] = -1
    gradient = np.concatenate([gradient for _ in bs], axis=0)
    gradient, dt = gradients.interpolate_gradient(gradient, T / (n0 - 1), 1000)
    gradient = gradients.set_b(gradient, dt, bs)
    substrate = substrates.mesh(
        mesh["vertices"], mesh["faces"], True, padding=np.zeros(3),
        init_pos="intra", n_sv=np.array([10, 10, 10]), quiet=True,
    )
    n = 10000
    t0 = time.perf_counter()
    signals, pos = simulations.simulation(
        n, DIFFUSIVITY, gradient, dt, substrate, final_pos=True, quiet=True,
        device="cuda",
    )
    wall = time.perf_counter() - t0
    misst = np.loadtxt(os.path.join(
        ORACLES,
        "misst_cylinder_signal_smalldelta_30ms_bigdelta_40ms_radius_5um.txt"))
    err = float(np.abs(signals / n - misst).max())
    r = np.max(np.linalg.norm(
        substrate.vertices[:, 0:2] - substrate.voxel_size[0:2] / 2, axis=1))
    length = substrate.voxel_size[2]
    radial = np.linalg.norm(
        pos[:, 0:2] - np.max(substrate.vertices, axis=0)[0:2] / 2, axis=1)
    leak = not (pos[:, 2].min() > 0 and pos[:, 2].max() < length
                and radial.max() < r)
    say(f"mesh MISST: {n} intra spins x 1000 steps x 100 b ({wall:.1f} s "
        f"incl. seeding and pack), max |S/n - MISST| = {err:.5f} (limit "
        f"0.015), leak {'YES' if leak else 'none'} (max radius "
        f"{radial.max():.4g} < {r:.4g} m)")
    if not err <= 0.015:
        raise AssertionError("mesh signal misses the MISST oracle")
    if leak:
        raise AssertionError("spins left the closed cylinder")


def _bundle_axes(bench):
    """(64, 2) cylinder axes (m) of the bundle in the substrate frame, and
    the (2,) voxel extent."""
    sp, (gx, gy) = bench["spacing"], bench["grid"]
    shift = -bench["vertices"].min(axis=0)[:2]
    centers = np.array([((i + 0.5) * sp, (j + 0.5) * sp)
                        for i in range(gx) for j in range(gy)]) + shift
    return centers, np.asarray(bench["substrate"].voxel_size)[:2]


def _nearest(p, points, vox):
    """Distance (m) of each (n, 2) point to the nearest of ``points``,
    periodic images included."""
    p = np.mod(p, vox)
    best = np.full(len(p), np.inf)
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            c = points + np.array([ox, oy]) * vox
            for k in range(0, len(c), 16):
                d = np.linalg.norm(p[:, None, :] - c[None, k:k + 16], axis=2)
                best = np.minimum(best, d.min(axis=1))
    return best


def _contacts(bench):
    """(k, 2) points (m) where two cylinders of the periodic bundle touch.

    bench.py's bundle is 31 um wide (substrates.mesh moves the mesh's
    corner to the origin), so the cylinders across the periodic boundary
    stand 2r apart and touch along lines parallel to z."""
    centers, vox = _bundle_axes(bench)
    imgs = np.concatenate([centers + np.array([ox, oy]) * vox
                           for ox in (-1, 0, 1) for oy in (-1, 0, 1)])
    d = np.linalg.norm(centers[:, None] - imgs[None], axis=2)
    i, j = np.nonzero((d > 0) & (d <= 2 * bench["radius"] * (1 + 1e-9)))
    return np.unique(np.round(np.mod((centers[i] + imgs[j]) / 2, vox), 12),
                     axis=0)


def _explain_changes(bench, changed, pos0, seed, eps):
    """Replay the spins that changed compartment and say why.

    Each spin is replayed through the kernel with its own id (the kernel's
    result for a spin does not depend on the other spins), then every epoch
    of the replay is run again by the plain torch version on the CPU from
    the kernel's state at the epoch's start. A spin is "reproduced" when
    the plain version gives the kernel's positions (within 1e-3 step
    lengths) at every step: its crossing is then the algorithm's, which the
    plain version shares with the JAX package, and not the kernel's. A
    crossing that is not reproduced must lie within 1.5 steps of a line
    where two cylinders touch.

    Returns (final replayed positions (k, 3) in m, number reproduced,
    number of crossings at contact lines, number of contact lines).
    """
    from dataclasses import replace

    from disimpy_tpu_torch.engine import fused

    spec, step_l, r = bench["spec"], bench["step_l"], bench["radius"]
    lo, hi = r * math.cos(math.pi / 32) * (1 - 1e-4), r * (1 + 1e-4)
    J, n_t, seed_k = spec.resort_every, 150, seed ^ spec.seed_salt
    centers, vox = _bundle_axes(bench)
    contacts = _contacts(bench)
    ids = torch.as_tensor(changed, dtype=torch.int32, device=pos0.device)
    start = pos0[:, ids.long()].contiguous()
    kern = [start[None]] + [steps for steps, _ in fused.epochs(
        spec, start, ids, 0, n_t, seed_k, eps, 1000)]
    kern = torch.cat(kern)[:n_t + 1].cpu()
    cpu_spec = replace(spec, **{f: getattr(spec, f).cpu() for f in (
        "table", "cell_start", "cell_packed", "cell_packed2", "voxel_size",
        "sv_width", "perm_prob")})
    gap = torch.zeros(len(changed))
    for t_base in range(0, n_t, J):
        steps, _ = next(fused.epochs(
            cpu_spec, kern[t_base].contiguous(), ids.cpu(), t_base,
            min(J, n_t - t_base), seed_k, eps, 1000))
        k_steps = kern[t_base + 1:t_base + 1 + J]
        gap = torch.maximum(gap, (steps[:len(k_steps)] - k_steps).abs()
                            .amax(dim=(0, 1)))
    reproduced = gap <= 1e-3
    traj = kern.numpy().astype(float) * step_l
    at_contact = 0
    for k in range(len(changed)):
        xy = traj[:, :2, k]
        side = np.where(_nearest(xy, centers, vox) < lo, 1,
                        np.where(_nearest(xy, centers, vox) > hi, -1, 0))
        steps = np.nonzero(side)[0]
        for a, b in zip(steps[:-1], steps[1:]):
            if side[a] == side[b]:
                continue
            near = _nearest(xy[a:b + 1], contacts, vox).min() <= 1.5 * step_l
            at_contact += int(near)
            if not (near or reproduced[k]):
                raise AssertionError(
                    f"spin {changed[k]} changed compartment between steps "
                    f"{a} and {b} away from any contact line, and the plain "
                    "version does not reproduce its trajectory")
    return traj[-1].T, int(reproduced.sum()), at_contact, len(contacts)


def bench_run(bench, smi):
    """Phase 6: the bench workload through simulation()."""
    from disimpy_tpu_torch import simulations
    from disimpy_tpu_torch.engine import fused_kernel

    n, n_t = 524288, 150
    sub, step_l = bench["substrate"], bench["step_l"]
    expected = math.ceil(n_t / bench["spec"].resort_every)
    r = bench["radius"]
    lo, hi = r * math.cos(math.pi / 32) * (1 - 1e-4), r * (1 + 1e-4)
    centers, vox = _bundle_axes(bench)
    scale = 1.0 / step_l
    eps = simulations._effective_epsilon(
        1e-13, scale, float(np.max(sub.voxel_size)) * scale, n_t,
        torch.float32, False)
    runs = {}
    for label, seed in (("warm-up", 1), ("timed", 2)):
        fused_kernel.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        signals, pos = simulations.simulation(
            n, DIFFUSIVITY, bench["gradient"], bench["dt"], sub, seed=seed,
            quiet=True, final_pos=True, device="cuda",
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = fused_kernel.launches
        if launched != expected:
            raise AssertionError(
                f"{label}: {launched} kernel launches, expected {expected}")
        if not np.all(np.isfinite(signals)):
            raise AssertionError(f"{label}: non-finite signals")
        pos0 = simulations._uniform_positions(
            n, np.asarray(sub.voxel_size) * scale, seed, "cuda")
        d0 = _nearest(pos0.cpu().numpy().T[:, :2].astype(float) * step_l,
                      centers, vox)
        d1 = _nearest(pos[:, :2], centers, vox)
        inside, outside = d0 < lo, d0 > hi
        changed = np.nonzero((inside & (d1 >= hi)) | (outside & (d1 <= lo)))[0]
        if len(changed) > MAX_CHANGED * n:
            raise AssertionError(
                f"{label}: {len(changed)} of {n} spins changed compartment")
        end, reproduced, at_contact, n_contacts = _explain_changes(
            bench, changed, pos0, seed, eps)
        if len(changed) and np.abs(end - pos[changed]).max() > 1e-3 * step_l:
            raise AssertionError(f"{label}: the replay of the changed spins "
                                 "does not reproduce the run")
        say(f"bench {label}: {n} spins x {n_t} steps x 32 meas in "
            f"{wall:.3f} s = {n * n_t / wall:.6g} spin-steps/s ({smi}); "
            f"{launched} kernel launches; signals finite; "
            f"{int(inside.sum())} inside / {int(outside.sum())} outside; "
            f"{len(changed)} compartment changes: {reproduced} reproduced "
            f"by the plain version epoch by epoch, {at_contact} crossings "
            f"within 1.5 steps of the {n_contacts} lines where cylinders "
            "touch across the periodic boundary")
        runs[label] = dict(wall=wall, launches=launched, changed=len(changed))
    return runs


def main():
    smi = card()
    threefry_check()
    bench = bench_setup()
    kp = kernel_vs_plain(bench)
    free_oracle()
    misst_oracle()
    runs = bench_run(bench, smi)
    print(json.dumps({"kernels": [{
        "name": "fused_epoch",
        "route": "cuda",
        "source": "disimpy_tpu_torch/csrc/fused_epoch.cu",
        "replaces": "disimpy_tpu/engine/pallas_fused.py:277",
        "launches": runs["timed"]["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in kp.values()),
        "ms": kp[524288, 0.0]["ms"],
        "plain_ms": kp[524288, 0.0]["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
