"""Drive the PyTorch port's main path once on one CUDA GPU and check it.

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
the CUDA toolkit:

    python3 chip_smoke.py

Phases, one line each (any failure raises, so the exit code is non-zero):

1. the card (name and power limit from nvidia-smi), torch and CUDA
   versions, and the builds of ``disimpy_tpu_torch/csrc/fused_epoch.cu``,
   ``csrc/mesh_hit.cu``, ``csrc/krng_draw.cu`` and
   ``csrc/analytic_step.cu`` (one nvcc each, started together), with
   the epoch kernel's default variant held to 64 registers and no spills;
2. the kernel's device threefry against ``engine/krng.py``, bit for bit;
3. the epoch kernel against its plain torch version on the bench bundle's
   pack (J = 4, perm 0 and 0.5; 16,384 sorted spins with equal iter_exc
   and transit counts, then the main path's 524,288): at most 0.5% of the
   spins diverge (positions more than 1e-4 step lengths apart), both
   times, the kernel's bound from the units the plain version folds, and
   the fold-lane efficiency of one thread, four and eight lanes per spin
   from the plain version's per-pass prefix counts; the counting variant
   beside the default one (its time; its outputs equal bit for bit; per
   spin the units folded and bounce passes, per warp the units issued,
   equal to the plain version's on every spin and warp that does not
   diverge); then a crafted unit with equal t at two sublanes and across
   two units, where kernel and plain version must give the same positions
   bit for bit;
4. free diffusion through ``simulation()`` against exp(-bD) (<= 0.01);
5. the closed cylinder mesh through ``simulation()`` against the vendored
   MISST signal (<= 0.015), with the leak checks of the JAX package's test
   on top of the radial one;

   phases 4, 5, 8 and 11 run their PARITY_r05 setups through
   ``scripts/parity_torch.py`` (``Parity.free``, ``mesh``, ``analytic`` and
   ``exchange``, one ``Parity`` for the whole script) and add their own
   checks on top;
6. the bench workload (102,400-triangle periodic bundle, 524,288 spins x
   150 steps x 32 measurements, uniform seeding) through ``simulation()``:
   pack time and static prefixes, a warm-up and a timed run, kernel
   launches per run, finite signals, at most 1e-4 of the spins changing
   compartment, and every such spin replayed: its crossing must be
   reproduced by the plain version from the kernel's states, or lie where
   two cylinders touch across the periodic boundary;
7. the nearest-hit kernel against its plain torch version on the bench
   bundle's classic (halo) pack: 524,288 spins uniform in the voxel with
   rem = 1 and rem uniform in (0, 1], in float32 (at most 1e-5 of the hit
   masks differ; elsewhere |d| within 1e-5 step lengths and |normal dot|
   >= 1 - 1e-5) and float64 (equal masks, |d| within 1e-12); both times
   and the bound; the same for the compacted batch the engine's second
   bounce pass sees (the full batch's hits reflected, at most 65,536);
   and the two tie cases of ``tests/test_torch_classic.py``, where the
   kernel must return the plain version's record;
8. the analytic oracles through ``simulation()``: sphere and cylinder
   against MISST at small delta 30 ms and 1 ms (1e5 spins x 1000 steps x
   100 b, <= 0.01), the equal-semiaxes ellipsoid against the sphere (3
   decimals), and confinement from the final positions (no spin beyond
   r + 1e-2 step lengths in the 30 ms sphere run, at most 1e-4 of the
   spins in the others);
9. the classic mesh engine: the closed cylinder mesh against MISST in
   float64 (<= 0.015, no leak), a float32 trajectory run (file shape,
   confinement), and the two runs the fused engine hands over (effective
   epsilon above its budget, dt = 0.2 s), all through the nearest-hit
   kernel;
10. the bench workload through the classic engine (``use_fused =
   False``): a warm-up and a timed run, kernel launches per run, finite
   signals, at most 1e-4 of the spins changing compartment, beside phase
   6's fused time;
11. the exchange and relaxation checks of ``PARITY_r05.json`` at their
   full size and thresholds: the closed cylinder mesh (perm 0.2, 1e5 intra
   spins x 200 steps, b = 0, T2 25 / 150 ms) through the fused engine
   (weight identity <= 1e-4, 1 / mean crossings <= 10) and again through
   the classic engine (mean crossings and intra fraction within 4 standard
   errors of the fused run), each with its kernel's launches; the
   permeable analytic sphere (weight identity, fraction outside); uniform
   T2 on free diffusion (<= 1e-5);
12. the tracked fused window, kernel against plain version, from 16,384
   intra starts of that cell (20 steps): crossings and intra steps equal
   for every spin whose positions agree, at most 0.5% divergent;
13. the bench workload with ``exchange_stats=True`` at 524,288 spins: the
   time the card takes to classify the uniform starts, the tracked run's
   time beside
   an untracked run and phase 6's; no transits, intra steps 0 or 150 in
   agreement with each start's distance to the nearest axis for all but
   at most 1e-5 of the starts (the float32 ray-parity classifier counts a
   grazed facet edge twice), and positions and signals equal to the
   untracked run's bit for bit;
14. the exchange cell (fused) and the permeable sphere (classic) at 1e5
   spins x 40 steps split into two parts on one card against one part:
   positions, crossings and intra steps equal per spin, signals within
   1e-6; and ``sweeps.sweep_sphere_radii`` (2, 4, 6, 8 um; 1e4 spins x
   1000 steps) against its four standalone runs (rtol 1e-6, atol 1e-5),
   with both times;
15. the PARITY_r05 checks that no phase above runs, through
   ``scripts/parity_torch.py``: the closed cylinder mesh over {periodic} x
   {padding} x {n_sv} against MISST (<= 0.015) with its radial leak check
   (<= 1e-3), and the neuron mesh's leak check at dt 1e-5 (no spin outside
   the voxel; the script runs the other two step sizes, whose host packs
   take minutes), one line per run with its engine, pack, seeding and wall
   times, and the three n_sv runs of each (periodic, padding) pair
   compared bit for bit; and one epoch of the kernel against its plain
   version, as in phase 3, on the non-periodic padded run's pack (65,536
   uniform spins, so the boundary cells' voxel-wall rows are folded);
16. bench.py's neuron workload (the 29,688-triangle neuron mesh,
   periodic, 524,288 spins x 150 steps x 32 measurements, uniform seeding)
   through ``simulation()``: the cold pack, one epoch of the kernel
   against its plain version on its table as in phase 3, a warm-up and a
   timed run, kernel launches, finite signals; then 32-step runs with the
   kernel's counting variant (``config.fused_count_units``) on the neuron
   and on the bundle: triangles tested and bounce passes per spin-step and
   the fold-lane efficiency, each run equal bit for bit to the same run
   without counting;
17. the J and width sweep: on the bundle and the neuron, for each epoch
   length J = 1..5 (``config.fused_resort_every``) and for the two cell
   widths either side of the searched one (``config.fused_cell_steps``, at
   J = 4), through ``simulation()``: the pack's host time, the J asked for
   and the J chosen, n_sv, units and table MB; one epoch of the kernel
   against its plain version on 16,384 sorted spins as in phase 3 (equal
   iter_exc and transit counts, at most 0.5% divergent, the counting
   variant's counts); the kernel's time per epoch at 524,288 spins (median
   and range of five readings); a warm-up and a timed run of 524,288 spins
   x 150 steps with ceil(150 / J) kernel launches and finite signals; a
   32-step counting run (triangles tested and bounce passes per spin-step,
   fold-lane efficiency); and the kernel's bound per epoch from that run's
   units and the table's bytes. The records are printed as one JSON line
   ("k1 sweep: ...");
18. the draws and the graph: the draw kernel (``csrc/krng_draw.cu``)
   against its plain version at 524,288 spins, J = 1..5, float32 and
   float64: the directions and the bounce uniforms (at one bounce index,
   and gathered at per-spin indices) bit for bit, both times and the
   bound, and the SASS instruction tally of the float32 directions kernel
   (``cuobjdump``); then, on the bundle and on the neuron at 524,288 spins
   x 150 steps x 32 measurements, graphed runs
   (``config.fused_cuda_graph``, the default) against eager ones: signals
   and final positions through ``simulation()``, and the window's
   positions, phases, iter_exc and trackers, untracked and tracked, bit for
   bit; walks with the kernel's draws against walks with the plain draws
   (at most 0.5% of the spins more than 1e-4 step lengths apart); the wall
   of the first call of the shape (the graphed one captures), the median
   and range of five timed runs each, the launches per run, and from one
   torch.profiler run each the device's busy share and the kernels it
   saw, which must equal the launches the wrappers counted.

19. the classic engine on the card: the step kernels against their plain
   versions on one step, the same positions and draws: K8
   (``csrc/analytic_step.cu``) at 524,288 spins on the sphere, cylinder
   and ellipsoid x float32 / float64 x perm 0 / 0.5 x one radius / a
   radius per spin, and at the analytic MISST runs' shape (1e5 spins in a
   5 um sphere and cylinder); the mesh step (the draw kernel, K2's passes
   with the first bounce resolved, K9 in ``csrc/mesh_hit.cu``: the listed
   spins sorted by cell, their second check on staged rows, the
   warp-per-spin remainder, the tail) at 524,288 spins on the bundle's
   halo pack in both types and perms, at a step 10 times longer (most
   spins reach the remainder) and at a budget of 3 checks (some spins end
   over it): K8 against its plain version, and the mesh step against the
   plain loop on K2's query, positions, exc and crossings bit for bit on
   every spin; the mesh step (and its first pass alone) against the plain
   loop on the gather query, at most 0.5% of the spins more than 1e-5
   (float32) or 1e-12 (float64) step lengths apart, counted; each step's
   time beside the earlier kernels', its collision checks, K2's and K9's
   parts and bounds (K9's counted from the plain loop's later queries);
   then classic
   windows graphed (``config.classic_cuda_graph``) against eager, bit for
   bit: the bundle tracked and with trajectories, a sphere sweep; the
   classic bundle (float32 and float64, 524,288 x 150 x 32) and the four
   analytic MISST runs (1e5 x 1000 x 100 b) through ``simulation()``
   graphed and eager: equal results, the first call, the median of five
   runs and the launches per run, one torch.profiler run of the float32
   bundle and of the 30 ms sphere each way (busy share; the kernels seen
   equal the launches counted; the step kernels' and the phase product's
   device time per launch; the operators that launched the eager run's
   busiest kernels); and the start classifier on the card against the
   CPU's on 524,288 points uniform in the bundle's voxel and in the
   neuron's (at most 1e-5 of them may differ).

The line before the last holds the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA GPU, or without the rest
of the repository beside it, the script fails before printing either.
"""

import collections
import dataclasses
import json
import math
import os
import pickle
import re
import shutil
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
# Most uniform starts of the bundle whose ray-parity class may contradict
# their distance to the nearest axis (phase 13).
MAX_MISCLASSIFIED = 1e-5
# Published peaks of one H100 SXM (NVIDIA's data sheet; dense, outside the
# tensor cores for floating point): the least time a kernel could take is
# the larger of its bytes over HBM_RATE and its operations over the peak.
HBM_RATE = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
# K1's time per epoch at 524,288 spins, perm 0, measured before its
# counting variant was added (NVIDIA H100 80GB HBM3, 700 W): phase 3 shows
# whether the default variant kept it.
K1_MS_BEFORE = (2.04, 2.17)
# K1's default variant's registers per thread (ptxas, sm_90a), checked in
# phase 1: the counting variant must not change them or make it spill.
K1_REGISTERS = 64


def bound(n_bytes, flops, dtype="float32"):
    """(bound_ms, bound_by) for a kernel that must move ``n_bytes`` and do
    ``flops`` operations of ``dtype``."""
    t_bytes = n_bytes / HBM_RATE
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


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
    from concurrent.futures import ThreadPoolExecutor

    from disimpy_tpu_torch.engine import _build

    names = ("fused_epoch", "mesh_hit", "krng_draw", "analytic_step")
    with ThreadPoolExecutor(len(names)) as pool:
        builds = list(pool.map(_build.load, names))
    for name, built in zip(names, builds):
        # Each kernel's entry line (mangled name: fused_epoch_kernel<true>
        # is the counting variant, "ILb1E") before its registers and spills.
        regs = [ln.strip() for ln in built.log.splitlines()
                if "registers" in ln or "spill" in ln
                or "Compiling entry" in ln]
        say(f"build: csrc/{name}.cu in {built.seconds:.2f} s -> "
            f"{os.path.relpath(built.path, REPO)}; ptxas: {' | '.join(regs)}")
    _check_k1_registers(builds[0].log)
    return smi


def _check_k1_registers(log):
    """K1's default variant (fused_epoch_kernel<false>) keeps the registers
    it had before the counting variant existed, with no spills."""
    lines = log.splitlines()
    first = next(i for i, ln in enumerate(lines)
                 if "Compiling entry" in ln and "fused_epoch_kernelILb0E" in ln)
    entry = []
    for ln in lines[first + 1:]:
        if "Compiling entry" in ln:
            break
        entry.append(ln)
    entry = " ".join(entry)
    spills = [int(v) for v in re.findall(r"(\d+) bytes spill (?:stores|loads)",
                                         entry)]
    regs = [int(v) for v in re.findall(r"Used (\d+) registers", entry)]
    if len(spills) != 2 or any(spills) or regs != [K1_REGISTERS]:
        raise AssertionError(
            f"fused_epoch_kernel<false>: spill stores/loads {spills}, "
            f"registers {regs} (expected no spills, {K1_REGISTERS})")
    say(f"fused_epoch_kernel<false>: {K1_REGISTERS} registers, no spills, as "
        "before the counting variant existed")


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


# bench.py's bundle: step duration and step length.
BUNDLE_DT = 1.3e-5
BUNDLE_STEP = float(np.sqrt(6 * DIFFUSIVITY * BUNDLE_DT))


def _bundle_substrate():
    """bench.py's bundle substrate: 8 x 8 open cylinders (r 1.5 um, 4 um
    apart, 32 facets x 25 segments), periodic. Returns (substrate,
    vertices, faces)."""
    from disimpy_tpu_torch import meshes, substrates

    vertices, faces = meshes.cylinder_array_mesh(
        1.5e-6, 4e-6, grid=(8, 8), length=32e-6, n_facets=32, n_segments=25
    )
    n_sv = max(1, int(4e-6 * 8 / (4.2 * BUNDLE_STEP)))
    substrate = substrates.mesh(
        vertices, faces, periodic=True, n_sv=np.array([n_sv] * 3), quiet=True
    )
    return substrate, vertices, faces


def bench_setup():
    """The bench bundle (bench.py's workload) and its pack, with the static
    prefix sizes the JAX package's pack gives (BENCH_r05.json tail)."""
    from disimpy_tpu_torch import gradients
    from disimpy_tpu_torch.engine import fused

    dt, step_l = BUNDLE_DT, BUNDLE_STEP
    radius, spacing, grid = 1.5e-6, 4e-6, (8, 8)
    t0 = time.perf_counter()
    substrate, vertices, faces = _bundle_substrate()
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
                spacing=spacing, grid=grid, pack_s=t_pack)


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


def _graph_ms(fn, reps):
    """Device time of one ``fn()`` in ms, for a call too short to time
    from the host (the wrapper's host time would be measured): ``reps``
    calls captured in one CUDA graph, replayed once to warm up, then timed
    over one replay."""
    fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


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


def fused_tie_case(device):
    """A crafted two-cell epoch whose first fold meets equal t at two
    sublanes and across two units.

    Three axis-aligned triangles (normals x, y, z, each E1 x E2 of unit
    length) pass through (1.5, 1.5, 1.5) in the cell-local frame; a spin
    at (0.5, 0.5, 0.5) moving along (1, 1, 1) meets all three at t = 1
    exactly, uses up its segment there and is offset eps off the winner.
    Cell 0 holds x at (unit 0, g 0, r 5), y at (unit 0, g 3, r 2) and z at
    (unit 1, g 0, r 2): y wins (lowest r, then the earlier unit). Cell 1
    holds the same in units 2 and 3 but z at (unit 3, g 1, r 1): z wins
    (a lower r in a later unit). Every value is a dyadic number, so the
    result is exact.

    Returns (spec, the ``fused_epoch`` arguments after the spec, the
    expected (J, 3, n) positions).
    """
    from disimpy_tpu_torch.engine import fused

    J, n_half, eps = 4, 8, 2.0 ** -8
    tris = {
        0: ((1.5, 1.25, 1.25), (1.5, 2.25, 1.25), (1.5, 1.25, 2.25)),
        1: ((1.25, 1.5, 1.25), (1.25, 1.5, 2.25), (2.25, 1.5, 1.25)),
        2: ((1.25, 1.25, 1.5), (2.25, 1.25, 1.5), (1.25, 2.25, 1.5)),
    }

    def features(axis):
        A, B, C = (np.array(v) for v in tris[axis])
        e1, e2 = B - A, C - A
        nrm = np.cross(e1, e2)
        return np.concatenate((nrm, [A @ nrm], e2, np.cross(e2, A), e1,
                               np.cross(A, e1)))

    table = np.zeros((4, 8, 128), np.float32)
    # (unit, group, sublane, axis): cell 0 -> units 0, 1; cell 1 -> 2, 3.
    for u, g, r, axis in ((0, 0, 5, 0), (0, 3, 2, 1), (1, 0, 2, 2),
                          (2, 0, 5, 0), (2, 3, 2, 1), (3, 1, 1, 2)):
        table[u, r, 16 * g:16 * g + 16] = features(axis)
    two = sum(2 << (fused.BITS * k) for k in range(len(fused.FINE_LADDER)))
    spec = fused.spec_from_numpy(
        dict(table=table, cell_start=np.array([0, 2]),
             cell_packed=np.full(2, two), cell_packed2=np.full(2, two),
             voxel_size=np.array([8.0, 4.0, 4.0]),
             sv_width=np.array([4.0, 4.0, 4.0]), perm_prob=np.array(0.0)),
        dict(n_sv=(2, 1, 1), resort_every=J, seed_salt=0, eps_budget=1e-3),
        device)
    n = 2 * n_half
    corner = np.repeat(np.array([[0.0, 0.0, 0.0], [4.0, 0.0, 0.0]]), n_half,
                       axis=0).T
    pos = corner + 0.5
    want = corner + 1.5
    want[1, :n_half] -= eps  # y wins in cell 0
    want[2, n_half:] -= eps  # z wins in cell 1

    def t(x, dtype=torch.float32):
        return torch.tensor(np.ascontiguousarray(x), dtype=dtype,
                            device=device)

    i32 = torch.int32
    args = (t(pos), t(np.ones((J, 3, n))), t(np.arange(n), i32),
            t(np.repeat([0, 2], n_half), i32), t(np.full(n, two), i32),
            t(np.full(n, two), i32), t(corner), 0, 1, 0, eps, 1000)
    return spec, args, t(np.broadcast_to(want, (J, 3, n)))


def _fused_tie_check():
    """The crafted tie unit through the kernel and its plain version:
    equal positions bit for bit, and the expected winners."""
    from disimpy_tpu_torch.engine import fused_kernel

    spec, args, want = fused_tie_case("cuda")
    kp, _, _ = fused_kernel.fused_epoch(spec, *args)
    pp, _, _ = fused_kernel.fused_epoch_reference(spec, *args)
    if not (torch.equal(kp, pp) and torch.equal(kp, want)):
        raise AssertionError(
            f"fused_epoch tie unit: kernel {kp[0].T.tolist()}, plain "
            f"{pp[0].T.tolist()}, expected {want[0].T.tolist()}")
    say("fused_epoch tie unit: equal t at two sublanes and across two units "
        "give the plain version's positions bit for bit (lowest r, then the "
        "earlier unit)")


def _fold_trace(run):
    """Run ``run()``, a call of the plain epoch, and return its result and
    the prefix counts it folded: one (step, pass, spin ids, cnt) per bounce
    pass, read by wrapping the plain version's fold and the uniform draw
    that follows it in the same pass."""
    from disimpy_tpu_torch.engine import fused_kernel, krng

    fold, draw = fused_kernel._fold_units, krng.bounce_uniform
    trace, last = [], []

    def fold_rec(table, start, cnt, *rest):
        last.append(cnt)
        return fold(table, start, cnt, *rest)

    def draw_rec(seed, t, ids, it):
        trace.append((t, it, ids, last.pop()))
        return draw(seed, t, ids, it)

    fused_kernel._fold_units, krng.bounce_uniform = fold_rec, draw_rec
    try:
        out = run()
    finally:
        fused_kernel._fold_units, krng.bounce_uniform = fold, draw
    return out, trace


def _lane_efficiency(trace, ids_s, spins_per_warp):
    """(units folded, units issued) by warps of ``spins_per_warp`` sorted
    spins: per pass a warp folds its spins' largest prefix count,
    spins_per_warp times over (32 for one thread per spin, 4 for groups
    of 8 lanes). Folded over issued is the fold-lane efficiency."""
    n = ids_s.shape[0]
    pos_of = torch.empty_like(ids_s, dtype=torch.long)
    pos_of[ids_s.long()] = torch.arange(n, device=ids_s.device)
    n_warps = -(-n // spins_per_warp)
    useful = issued = 0
    for _, _, ids, cnt in trace:
        warp = pos_of[ids.long()] // spins_per_warp
        most = torch.zeros(n_warps, dtype=torch.long, device=ids_s.device)
        most.scatter_reduce_(0, warp, cnt.long(), "amax")
        useful += int(cnt.sum())
        issued += int(most.sum())
    return useful, spins_per_warp * issued


def _count_check(counts, plain_counts, divergent, trace_issued):
    """The counting variant against the plain version's counts: per-spin
    units and passes equal on every spin that does not diverge, per-warp
    issued units equal on every warp without a divergent spin, and the
    plain version's issued total equal to the one its fold trace gives.
    Returns (units, passes, issued) of the kernel, summed."""
    from disimpy_tpu_torch.engine import fused_kernel

    (ku, kpass, kiss), (pu, ppass, piss) = counts, plain_counts
    spins_off = int(((ku != pu) | (kpass != ppass))[~divergent].sum())
    warp_div = torch.zeros_like(kiss, dtype=torch.bool)
    warp_div[divergent.nonzero()[:, 0] // fused_kernel.SPINS_PER_WARP] = True
    warps_off = int((kiss != piss)[~warp_div].sum())
    plain_issued = int(piss.sum(dtype=torch.int64))
    if spins_off or warps_off or plain_issued != trace_issued:
        raise AssertionError(
            f"counting variant: {spins_off} non-divergent spins with other "
            f"units or passes, {warps_off} warps without a divergent spin "
            f"with other issued units; plain issued {plain_issued}, from its "
            f"fold trace {trace_issued}")
    return tuple(int(c.sum(dtype=torch.int64)) for c in counts)


def _epoch_vs_plain(spec, n, eps, exact=False):
    """One epoch of the kernel on ``n`` uniform spins of ``spec``, sorted
    as the driver sorts them, against its plain version on the same
    inputs, and the counting variant against the default one and the
    plain version's counts.

    A spin whose positions differ by more than 1e-4 step lengths counts as
    divergent, as does one whose iter_exc or transit count differs (with
    ``exact`` those must be equal); at most 0.5% of the spins may diverge.
    The counting variant must give the default variant's outputs bit for
    bit and the plain version's counts (:func:`_count_check`). Returns the
    times, errors, counts, fold-lane efficiencies and bound.
    """
    from disimpy_tpu_torch.engine import fused, fused_kernel

    J = spec.resort_every
    inputs, seed_k = _sorted_epoch_inputs(spec, n, seed=11)
    args = (spec, *inputs, 0, J, seed_k, eps, 1000)
    ms, (kp, ke, kc) = _cuda_ms(lambda: fused_kernel.fused_epoch(*args), 20)
    count_ms, (cp, ce, cc, counts) = _cuda_ms(
        lambda: fused_kernel.fused_epoch(*args, count=True), 20)
    if not (torch.equal(kp, cp) and torch.equal(ke, ce)
            and torch.equal(kc, cc)):
        raise AssertionError("the counting variant changes the epoch's "
                             "outputs")
    (plain_ms, (pp, pe, pc, plain_counts)), trace = _fold_trace(
        lambda: _cuda_ms(lambda: fused_kernel.fused_epoch_reference(
            *args, count=True), 1))
    units = int(plain_counts[0].sum(dtype=torch.int64))
    lanes = {w: _lane_efficiency(trace, inputs[2], w) for w in (32, 8, 4)}
    # Bytes: the whole table read once, each spin's inputs (pos 3, dirs 3J,
    # corner 3 floats, four int32 words) and outputs (positions 3J floats,
    # J transit counts, one exc byte).
    n_bytes = (spec.table.numel() * 4 + n * (4 * (6 + 3 * J) + 16)
               + n * (16 * J + 1))
    flops = units * fused.UNIT_TRIS * fused_kernel.FLOPS_PER_TRIANGLE
    bound_ms, bound_by = bound(n_bytes, flops)
    err = (kp - pp).abs().amax(dim=(0, 1))
    counts_differ = (ke != pe) | (kc != pc).any(dim=0)
    if exact and bool(counts_differ.any()):
        raise AssertionError("iter_exc or transit counts differ")
    divergent = (err > 1e-4) | counts_differ
    frac_div = float(divergent.float().mean())
    if frac_div > 0.005:
        raise AssertionError(f"{frac_div:.4%} of {n} spins diverge")
    k_units, k_passes, k_issued = _count_check(
        counts, plain_counts, divergent, lanes[4][1])
    return dict(max_abs_err=float(err.max()), ms=ms, count_ms=count_ms,
                plain_ms=plain_ms, divergent=frac_div, bound_ms=bound_ms,
                bound_by=bound_by, n_bytes=n_bytes, flops=flops, units=units,
                changed=int(counts_differ.sum()), transits=(int(kc.sum()),
                                                             int(pc.sum())),
                lanes={w: u / i for w, (u, i) in lanes.items()},
                counts=(k_units, k_passes, k_issued))


def _say_epoch(label, r):
    """One line of :func:`_epoch_vs_plain`'s result."""
    k_units, k_passes, k_issued = r["counts"]
    say(f"{label}: {r['changed']} spins with other iter_exc or transits "
        f"(kernel {r['transits'][0]}, plain {r['transits'][1]}); divergent "
        f"fraction {r['divergent']:.6f} (limit 0.005); max |err| "
        f"{r['max_abs_err']:.3g} step lengths; kernel {r['ms']:.4f} ms, "
        f"counting variant {r['count_ms']:.4f} ms (outputs equal bit for "
        f"bit), plain {r['plain_ms']:.2f} ms per epoch; {r['units']} units "
        f"folded = {r['flops']:.4g} flops, {r['n_bytes'] / 1e6:.1f} MB -> "
        f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}); fold-lane "
        f"efficiency from the plain version's prefix counts: "
        f"{r['lanes'][32]:.4f} one thread per spin, {r['lanes'][8]:.4f} four "
        f"lanes per spin, {r['lanes'][4]:.4f} eight lanes per spin (the "
        f"kernel's); the counting variant's: {k_units} units folded, "
        f"{k_passes} bounce passes, {k_issued} issued -> efficiency "
        f"{k_units / k_issued:.4f}; per-spin units and passes and per-warp "
        "issued units equal to the plain version's on every spin and warp "
        "that does not diverge")


def kernel_vs_plain(bench):
    """Phase 3: the kernel against its plain version on the bench pack
    (:func:`_epoch_vs_plain`), at 16,384 sorted spins, where iter_exc and
    the transit counts must be equal, and at the main path's 524,288; then
    the crafted tie unit (:func:`fused_tie_case`).
    """
    from dataclasses import replace

    from disimpy_tpu_torch.simulations import _effective_epsilon

    base = bench["spec"]
    scale = 1.0 / bench["step_l"]
    eps = _effective_epsilon(
        1e-13, scale, float(np.max(bench["substrate"].voxel_size)) * scale,
        150, torch.float32, False)
    record = {}
    for n in (16384, 524288):
        for perm in (0.0, 0.5):
            spec = replace(base, perm_prob=torch.tensor(perm, device="cuda"))
            r = _epoch_vs_plain(spec, n, eps, exact=n == 16384)
            _say_epoch(f"kernel vs plain, perm {perm}: {n} spins x "
                       f"J={spec.resort_every}", r)
            record[n, perm] = r
    lo, hi = K1_MS_BEFORE
    k1 = record[524288, 0.0]["ms"]
    say(f"default variant at 524,288 spins, perm 0: {k1:.4f} ms per epoch, "
        f"{'inside' if lo <= k1 <= hi else 'OUTSIDE'} the {lo}-{hi} ms it "
        "took before the counting variant existed (H100 80GB HBM3, 700 W; a "
        "card with a lower power limit runs slower, so this is reported, "
        "not checked)")
    _fused_tie_check()
    return record


def _parity_torch():
    """``scripts/parity_torch.py``, which holds the PARITY_r05 setups."""
    scripts = os.path.join(REPO, "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import parity_torch

    return parity_torch


def _require(parity, *keys):
    """Fail unless every named check of ``parity`` met its threshold."""
    failed = [k for k in keys if not parity.results[k]["pass"]]
    if failed:
        raise AssertionError(f"parity checks failed: {failed}")


def free_oracle(parity):
    """Phase 4: free diffusion against exp(-bD) (``Parity.free``)."""
    parity.free()
    r = parity.results["free_vs_exp"]
    say(f"free diffusion: {parity.n(1e5)} spins x {parity.t(1000)} steps x "
        f"100 b in {r['wall_s']:.1f} s, max |S/n - exp(-bD)| = "
        f"{r['value']:.5f} (limit 0.01)")
    _require(parity, "free_vs_exp")


def misst_oracle(parity):
    """Phase 5: the closed cylinder mesh against the MISST signal
    (``Parity.mesh`` on its periodic, unpadded, n_sv 10^3 cell), with the
    leak checks of the JAX package's test on top of its radial one."""
    pt = _parity_torch()
    n_sv = (10, 10, 10)
    key = pt.mesh_key(True, 0, n_sv)
    _, pos = parity.mesh(periodic=(True,), padding=(0,), n_svs=(n_sv,))[key]
    substrate = parity.substrates[key]
    r = np.max(np.linalg.norm(
        substrate.vertices[:, 0:2] - substrate.voxel_size[0:2] / 2, axis=1))
    length = substrate.voxel_size[2]
    radial = np.linalg.norm(
        pos[:, 0:2] - np.max(substrate.vertices, axis=0)[0:2] / 2, axis=1)
    leak = not (pos[:, 2].min() > 0 and pos[:, 2].max() < length
                and radial.max() < r)
    run = parity.results[key]
    say(f"mesh MISST: {parity.n(1e4)} intra spins x {parity.t(1000)} steps "
        f"x 100 b ({run['wall_s']:.1f} s incl. seeding and pack, "
        f"{run['engine']}), "
        f"max |S/n - MISST| = {run['value']:.5f} (limit 0.015), leak "
        f"{'YES' if leak else 'none'} (max radius {radial.max():.4g} < "
        f"{r:.4g} m)")
    _require(parity, key, key + "_leak")
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
    from disimpy_tpu_torch import parallel
    from disimpy_tpu_torch.engine import fused

    spec, step_l, r = bench["spec"], bench["step_l"], bench["radius"]
    lo, hi = r * math.cos(math.pi / 32) * (1 - 1e-4), r * (1 + 1e-4)
    J, n_t, seed_k = spec.resort_every, 150, seed ^ spec.seed_salt
    centers, vox = _bundle_axes(bench)
    contacts = _contacts(bench)
    ids = torch.as_tensor(changed, dtype=torch.int32, device=pos0.device)
    start = pos0[:, ids.long()].contiguous()
    kern = [start[None]] + [steps for steps, *_ in fused.epochs(
        spec, start, ids, 0, n_t, seed_k, eps, 1000)]
    kern = torch.cat(kern)[:n_t + 1].cpu()
    cpu_spec = parallel.spec_to(spec, torch.device("cpu"))
    gap = torch.zeros(len(changed))
    for t_base in range(0, n_t, J):
        steps = next(fused.epochs(
            cpu_spec, kern[t_base].contiguous(), ids.cpu(), t_base,
            min(J, n_t - t_base), seed_k, eps, 1000))[0]
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
    from disimpy_tpu_torch.engine import launch_count

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
        launch_count.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        signals, pos = simulations.simulation(
            n, DIFFUSIVITY, bench["gradient"], bench["dt"], sub, seed=seed,
            quiet=True, final_pos=True, device="cuda",
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_count.counts
        launched, draws = counts["fused_epoch"], counts["krng_draw"]
        if launched != expected or draws != expected:
            raise AssertionError(
                f"{label}: {launched} fused_epoch and {draws} krng_draw "
                f"launches, expected {expected} each")
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
            f"{launched} fused_epoch and {draws} krng_draw launches (full "
            "epochs replayed from one CUDA graph); signals finite; "
            f"{int(inside.sum())} inside / {int(outside.sum())} outside; "
            f"{len(changed)} compartment changes: {reproduced} reproduced "
            f"by the plain version epoch by epoch, {at_contact} crossings "
            f"within 1.5 steps of the {n_contacts} lines where cylinders "
            "touch across the periodic boundary")
        runs[label] = dict(wall=wall, launches=launched, draws=draws,
                           changed=len(changed))
    return runs


def _hit_check(name, label, spec, r0, direction, rem):
    """Time the nearest-hit kernel and its plain version on one batch and
    hold the kernel to it: float32 at most 1e-5 of the hit masks differ,
    |d| within 1e-5 step lengths and |normal dot| >= 1 - 1e-5 on the hits;
    float64 equal masks, |d| within 1e-12. Returns (record, plain (d,
    normal))."""
    from disimpy_tpu_torch.engine import mesh_kernel

    n = r0.shape[0]
    args = (spec, r0.contiguous(), direction.contiguous(), rem.contiguous())
    ms, (dk, nk) = _cuda_ms(lambda: mesh_kernel.nearest_hit(*args), 20)
    plain_ms, (dp, np_) = _cuda_ms(
        lambda: mesh_kernel.nearest_hit_reference(*args), 3)
    # Hit masks (d <= rem: the hits the engine acts on) and forward masks
    # (any finite d); distances and normals are held on the spins that hit
    # in both, and the far forward hits are shown.
    hk, hp = dk <= args[3], dp <= args[3]
    fk, fp = torch.isfinite(dk), torch.isfinite(dp)
    differ = (hk != hp) | (fk != fp)
    both = hk & hp
    err = float((dk - dp)[both].abs().max())
    worst = float((nk * np_).sum(dim=1).abs()[both].min())
    far = fk & fp & ~both
    rel_far = (float(((dk - dp).abs() / dp)[far].max()) if bool(far.any())
               else 0.0)
    n_differ = int(differ.sum())
    if name == "float32":
        ok = n_differ <= 1e-5 * n and err <= 1e-5 and worst >= 1 - 1e-5
    else:
        ok = n_differ == 0 and err <= 1e-12 and worst >= 1 - 1e-12
    # The work this input needs: one test per record of each spin's row;
    # each touched row's records read once, the spins' inputs read once and
    # outputs written once.
    cell, _ = mesh_kernel.halo_cells(*args)
    tested = int(spec.cell_counts[cell].sum())
    touched = torch.unique(cell)
    item = spec.tri.element_size()
    n_bytes = (int(spec.cell_counts[touched].sum()) * 12 * item
               + spec.cell_counts.numel() * 4 + n * 7 * item + n * 4 * item)
    flops = tested * mesh_kernel.FLOPS_PER_RECORD
    bound_ms, bound_by = bound(n_bytes, flops, name)
    say(f"mesh_hit vs plain ({name}, {label}): {n} spins, "
        f"{int(hk.sum())} hits within rem ({int(fk.sum())} forward hits); "
        f"{n_differ} spins with other masks; max |d| diff {err:.3g} step "
        f"lengths on the hits (on the farther forward hits: {rel_far:.3g} "
        f"relative); min |normal dot| {worst:.9f} on the hits; "
        f"{tested / n:.1f} records tested per spin (max "
        f"{int(spec.cell_counts[cell].max())}); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms; {flops:.4g} flops, {n_bytes / 1e6:.1f} MB -> "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    if not ok:
        raise AssertionError(f"mesh_hit ({name}, {label}) disagrees with its "
                             "plain version")
    record = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                  bound_ms=bound_ms, bound_by=bound_by)
    return record, (dp, np_)


def _hit_tie_cases():
    """The two tie cases of tests/test_torch_classic.py through the kernel:
    the tent (two triangles sharing the edge that is hit) must return the
    plain version's record, one triangle's normal; the same triangle
    stored twice must return the first record."""
    from disimpy_tpu_torch.engine import mesh_kernel, specs

    o = np.array([10.0, 10.0, 10.0] * 3)
    t1 = np.array([0, 0, 0, 0, 1, 0, 1, 0, -0.75]) + o
    n1 = np.array([-0.6, 0.0, -0.8])
    t2 = np.array([0, 0, 0, 0, 1, 0, -1, 0, -4.0 / 3.0]) + o
    n2 = np.array([-0.8, 0.0, 0.6])
    for dtype in (torch.float32, torch.float64):
        kw = dict(dtype=dtype, device="cuda")
        for label, records in (("tent", [np.r_[t1, n1], np.r_[t2, n2]]),
                               ("duplicate", [np.r_[t1, n1], np.r_[t1, -n2]])):
            spec = specs.MeshSpec(
                tri=torch.tensor(np.array(records), **kw)[None, None],
                cell_counts=torch.tensor([2], dtype=torch.int32,
                                         device="cuda"),
                voxel_size=torch.full((3,), 100.0, **kw),
                sv_width=torch.full((3,), 100.0, **kw),
                perm_prob=torch.tensor(0.0, **kw), n_sv=(1, 1, 1),
                spans=(1, 1, 1), chunk=2)
            args = (spec, torch.tensor([[10.0, 10.5, 9.0]], **kw),
                    torch.tensor([[0.0, 0.0, 1.0]], **kw),
                    torch.tensor([2.0], **kw))
            dk, nk = mesh_kernel.nearest_hit(*args)
            dp, np_ = mesh_kernel.nearest_hit_reference(*args)
            want = torch.tensor(n1, **kw) if label == "duplicate" else np_[0]
            if not (torch.equal(nk[0], np_[0]) and torch.equal(nk[0], want)
                    and abs(float(dk[0]) - 1.0) <= 1e-6
                    and abs(float(dk[0] - dp[0])) <= 1e-6):
                raise AssertionError(
                    f"mesh_hit tie ({label}, {dtype}): kernel {dk.tolist()} "
                    f"{nk.tolist()}, plain {dp.tolist()} {np_.tolist()}")
    say("mesh_hit ties: the tent and the duplicate record return the plain "
        "version's record (float32 and float64)")


def mesh_hit_vs_plain(bench):
    """Phase 7: the nearest-hit kernel against its plain version on the
    bench bundle's classic pack, float32 and float64: the full batch (rem
    = 1 and rem uniform in (0, 1]), the compacted batch the engine's second
    bounce pass sees, and the two tie cases. Returns the float32 rem = 1
    record (the shape of a step's first, full-batch query) with the largest
    error of all the batches."""
    from disimpy_tpu_torch import simulations
    from disimpy_tpu_torch.engine import stepping

    sub, step_l = bench["substrate"], bench["step_l"]
    scale = 1.0 / step_l
    n = 524288
    g = torch.Generator(device="cuda").manual_seed(5)
    records = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        t0 = time.perf_counter()
        spec = simulations._classic_mesh_spec(sub, scale, dtype,
                                              torch.device("cuda"))
        t_pack = time.perf_counter() - t0
        if tuple(spec.spans) != (1, 1, 1):
            raise AssertionError("the bench bundle's classic pack is not halo")
        say(f"classic pack ({name}): tri {tuple(spec.tri.shape)}, "
            f"{spec.tri.numel() * spec.tri.element_size() / 1e6:.1f} MB, "
            f"{t_pack:.2f} s host")
        vox = spec.voxel_size.to(dtype)
        r0 = (torch.rand((n, 3), generator=g, device="cuda", dtype=dtype)
              * vox)
        direction = torch.randn((n, 3), generator=g, device="cuda",
                                dtype=dtype)
        direction = direction / direction.norm(dim=1, keepdim=True)
        ones = torch.ones(n, dtype=dtype, device="cuda")
        records[name, "1"], (d, normal) = _hit_check(
            name, "rem 1", spec, r0, direction, ones)
        records[name, "uniform"], _ = _hit_check(
            name, "rem uniform", spec, r0, direction,
            1.0 - torch.rand(n, generator=g, device="cuda", dtype=dtype))
        # The second bounce pass of step_mesh: the full batch's hits
        # reflected at their hit points with rem - d left, at most n / 8.
        eps = simulations._effective_epsilon(
            1e-13, scale, float(np.max(sub.voxel_size)) * scale, 150, dtype,
            False)
        hit = d <= ones + stepping._hit_slack(dtype)
        r1, dir1, rem1, _ = stepping._resolve_mesh_hits(
            spec, r0, direction, ones, d, normal, hit, ones, eps)
        idx = (hit & (rem1 > 0)).nonzero()[:n // 8, 0]
        records[name, "compacted"], _ = _hit_check(
            name, "compacted second pass", spec, r1[idx], dir1[idx],
            rem1[idx])
    _hit_tie_cases()
    full = dict(records["float32", "1"])
    full["max_abs_err"] = max(r["max_abs_err"] for r in records.values())
    return full


# The b-values of the vendored MISST signals.
MISST_B = np.linspace(1, 3e9, 100)


def _misst_gradient(small_delta_ms, n_t=1000):
    """The PGSE protocols of the vendored MISST signals
    (``parity_torch.misst_protocol``)."""
    return _parity_torch().misst_protocol(small_delta_ms, MISST_B, n_t)


def analytic_oracles(parity):
    """Phase 8: sphere and cylinder against MISST (``Parity.analytic``),
    with confinement from their final positions on top, and ellipsoid ==
    sphere."""
    from disimpy_tpu_torch import simulations, substrates

    n, r = parity.n(1e5), 5e-6
    runs = parity.analytic()
    n_t = parity.t(1000)
    for (kind, small_delta), (_, pos) in runs.items():
        _, dt = _misst_gradient(small_delta, n_t)
        step_l = np.sqrt(6 * DIFFUSIVITY * dt)
        radial = (np.linalg.norm(pos, axis=1) if kind == "sphere"
                  else np.linalg.norm(pos[:, :2], axis=1))
        over = (radial.max() - r) / step_l
        escaped = int((radial > r + 1e-2 * step_l).sum())
        # A float32 step that ends within rounding of the wall can land
        # outside it; moving outward next, the impermeable far-root rule
        # finds no root and the spin leaves (the JAX package: 1 of 1e5
        # sphere spins at small delta 1 ms, ROADMAP section 3).
        allowed = 0 if (kind, small_delta) == ("sphere", 30) else 1e-4 * n
        key = f"{kind}_misst_{small_delta}ms"
        say(f"{kind} MISST, small delta {small_delta} ms: {n} spins x "
            f"{n_t} steps x 100 b in {parity.results[key]['wall_s']:.1f} s, "
            f"max |S/n - MISST| = {parity.results[key]['value']:.5f} (limit "
            f"0.01); {escaped} spins beyond r + 1e-2 step lengths (limit "
            f"{allowed:g}), max radius - r = {over:.3g} step lengths")
        _require(parity, key)
        if escaped > allowed:
            raise AssertionError(f"{kind} does not confine its spins")
    sphere_30 = runs["sphere", 30][0]
    gradient, dt = _misst_gradient(30, n_t)
    ellipsoid = simulations.simulation(
        n, DIFFUSIVITY, gradient, dt, substrates.ellipsoid(np.ones(3) * r),
        quiet=True, device="cuda")
    diff = float(np.abs(ellipsoid / n - sphere_30 / n).max())
    say(f"ellipsoid with equal semiaxes vs sphere: max |diff| = {diff:.3g} "
        "(3 decimals: < 1.5e-3)")
    if not diff < 1.5e-3:
        raise AssertionError("the equal-semiaxes ellipsoid is not the sphere")


def _closed_cylinder():
    from disimpy_tpu_torch import substrates

    with open(os.path.join(ORACLES, "cylinder_mesh_closed.pkl"), "rb") as f:
        mesh = pickle.load(f)
    return substrates.mesh(
        mesh["vertices"], mesh["faces"], True, padding=np.zeros(3),
        init_pos="intra", n_sv=np.array([10, 10, 10]), quiet=True,
    )


def classic_mesh():
    """Phase 9: the classic mesh engine (float64 MISST, float32
    trajectories) through the nearest-hit kernel."""
    import tempfile

    from disimpy_tpu_torch import simulations
    from disimpy_tpu_torch.engine import launch_count

    substrate = _closed_cylinder()
    gradient, dt = _misst_gradient(30)
    n = 10000
    launch_count.reset()
    t0 = time.perf_counter()
    signals, pos = simulations.simulation(
        n, DIFFUSIVITY, gradient, dt, substrate, final_pos=True, quiet=True,
        dtype="float64", device="cuda",
    )
    wall = time.perf_counter() - t0
    launched = launch_count.counts["mesh_hit"]
    misst = np.loadtxt(os.path.join(
        ORACLES,
        "misst_cylinder_signal_smalldelta_30ms_bigdelta_40ms_radius_5um.txt"))
    err = float(np.abs(signals / n - misst).max())
    r = np.max(np.linalg.norm(
        substrate.vertices[:, 0:2] - substrate.voxel_size[0:2] / 2, axis=1))
    length = substrate.voxel_size[2]
    centre = np.max(substrate.vertices, axis=0)[0:2] / 2
    radial = np.linalg.norm(pos[:, 0:2] - centre, axis=1)
    leak = not (pos[:, 2].min() > 0 and pos[:, 2].max() < length
                and radial.max() < r)
    say(f"classic mesh MISST (float64): {n} intra spins x 1000 steps x 100 b "
        f"in {wall:.1f} s, {launched} mesh_hit launches; max |S/n - MISST| "
        f"= {err:.5f} (limit 0.015), leak {'YES' if leak else 'none'}")
    if not err <= 0.015:
        raise AssertionError("classic mesh signal misses the MISST oracle")
    if leak:
        raise AssertionError("spins left the closed cylinder")
    if launched <= 0:
        raise AssertionError("the classic mesh run did not launch mesh_hit")

    n_s, n_t = 100, 100
    gradient, dt = _misst_gradient(30, n_t)
    launch_count.reset()
    with tempfile.TemporaryDirectory() as tmp:
        traj = os.path.join(tmp, "traj.txt")
        _, pos = simulations.simulation(
            n_s, DIFFUSIVITY, gradient, dt, substrate, traj=traj,
            final_pos=True, quiet=True, device="cuda")
        trajectories = np.loadtxt(traj)
    launched = launch_count.counts["mesh_hit"]
    if trajectories.shape != (n_t + 1, 3 * n_s):
        raise AssertionError(f"trajectory file shape {trajectories.shape}")
    trajectories = trajectories.reshape(n_t + 1, n_s, 3)
    radial = np.linalg.norm(trajectories[..., 0:2] - centre, axis=2)
    confined = (radial.max() < r and trajectories[..., 2].min() > 0
                and trajectories[..., 2].max() < length
                and np.allclose(trajectories[-1], pos, rtol=1e-7, atol=1e-16))
    say(f"classic mesh trajectories (float32): {n_s} spins x {n_t} steps, "
        f"file {(n_t + 1, 3 * n_s)}, {launched} mesh_hit launches, "
        f"{'confined' if confined else 'NOT confined'}")
    if not confined:
        raise AssertionError("trajectory file not confined or not final_pos")
    if launched <= 0:
        raise AssertionError("the trajectory run did not launch mesh_hit")

    # The runs the fused engine hands over: an effective epsilon above its
    # table's drift budget, and steps five voxels long (no fused
    # configuration fits; the halo row holds ~340 periodic images).
    gradient = np.zeros((2, 20, 3))
    gradient[1, 2:8, 0], gradient[1, 12:18, 0] = 0.05, -0.05
    for label, n_s, kw in (("epsilon 1e-7 m", 64, dict(epsilon=1e-7, dt=1e-4)),
                           ("dt 0.2 s", 8, dict(dt=0.2))):
        sub = _closed_cylinder()
        launch_count.reset()
        signals = simulations.simulation(
            n_s, DIFFUSIVITY, gradient[:, :3] if kw["dt"] > 0.1 else gradient,
            substrate=sub, quiet=True, device="cuda", **kw)
        launched = launch_count.counts["mesh_hit"]
        classic = any(k[0] == "classic-torch" for k in sub._accel_cache)
        say(f"fused handover ({label}): {n_s} spins, classic engine "
            f"{'used' if classic else 'NOT used'}, {launched} mesh_hit "
            f"launches, signals {signals.round(6).tolist()}")
        if not (classic and launched > 0 and np.all(np.isfinite(signals))
                and abs(signals[0] - n_s) < 1e-6 * n_s):
            raise AssertionError(f"fused handover ({label}) failed")


def classic_bench(bench, smi, fused_runs):
    """Phase 10: the bench workload through the classic engine."""
    from disimpy_tpu_torch import simulations
    from disimpy_tpu_torch.engine import config, launch_count

    n, n_t = 524288, 150
    sub, step_l = bench["substrate"], bench["step_l"]
    r = bench["radius"]
    lo, hi = r * math.cos(math.pi / 32) * (1 - 1e-4), r * (1 + 1e-4)
    centers, vox = _bundle_axes(bench)
    scale = 1.0 / step_l
    runs = {}
    try:
        config.use_fused = False
        for label, seed in (("warm-up", 1), ("timed", 2)):
            launch_count.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            signals, pos = simulations.simulation(
                n, DIFFUSIVITY, bench["gradient"], bench["dt"], sub,
                seed=seed, quiet=True, final_pos=True, device="cuda",
            )
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_count.counts
            launched, draws = counts["mesh_hit"], counts["krng_draw"]
            if launched <= 0 or draws <= 0 or counts["fused_epoch"]:
                raise AssertionError(
                    f"{label}: {launched} mesh_hit, {draws} krng_draw and "
                    f"{counts['fused_epoch']} fused_epoch launches; the "
                    "classic engine must launch mesh_hit and krng_draw only")
            if not np.all(np.isfinite(signals)):
                raise AssertionError(f"{label}: non-finite signals")
            pos0 = simulations._uniform_positions(
                n, np.asarray(sub.voxel_size) * scale, seed, "cuda")
            d0 = _nearest(pos0.cpu().numpy().T[:, :2].astype(float) * step_l,
                          centers, vox)
            d1 = _nearest(pos[:, :2], centers, vox)
            inside, outside = d0 < lo, d0 > hi
            changed = np.nonzero((inside & (d1 >= hi))
                                 | (outside & (d1 <= lo)))[0]
            if len(changed) > MAX_CHANGED * n:
                raise AssertionError(
                    f"{label}: {len(changed)} of {n} spins changed "
                    "compartment")
            say(f"classic bench {label}: {n} spins x {n_t} steps x 32 meas "
                f"in {wall:.3f} s = {n * n_t / wall:.6g} spin-steps/s "
                f"({smi}); {launched} mesh_hit and {draws} krng_draw "
                "launches; signals finite; "
                f"{len(changed)} compartment changes; fused engine "
                f"{label} run (phase 6): {fused_runs[label]['wall']:.3f} s")
            runs[label] = dict(wall=wall, launches=launched, draws=draws,
                               changed=len(changed))
    finally:
        config.use_fused = None
    return runs


# The two-compartment T2 pair of the PARITY exchange checks
# (scripts/parity_r04.py): intra 25 ms, extra 150 ms.
T2_PAIR = (25e-3, 150e-3)


def _exchange_cylinder(perm=0.2):
    """The closed cylinder mesh of the PARITY exchange checks: periodic,
    n_sv 10^3, intra seeding."""
    from disimpy_tpu_torch import substrates

    with open(os.path.join(ORACLES, "cylinder_mesh_closed.pkl"), "rb") as f:
        mesh = pickle.load(f)
    return substrates.mesh(
        mesh["vertices"], mesh["faces"], True, init_pos="intra",
        n_sv=np.array([10, 10, 10]), quiet=True, perm_prob=perm,
    )


def _weight_gap(signal, intra_steps, n_t, dt):
    """|S - sum w| / sum w at b = 0, w the relaxation weights the dwell
    steps imply."""
    k = intra_steps.astype(float)
    w = np.exp(-(dt / T2_PAIR[0]) * k - (dt / T2_PAIR[1]) * (n_t - k))
    return abs(float(signal) - w.sum()) / w.sum()


def exchange_oracles(parity):
    """Phase 11: the five PARITY checks of exchange and relaxation at their
    full size and thresholds (``Parity.exchange``), each run's kernel
    launches, and the exchange cell again through the classic engine."""
    from disimpy_tpu_torch.engine import config

    runs = parity.exchange()
    sub, stats, run = runs["cell"]
    n, n_t, dt = parity.n(1e5), parity.t(200), 2e-4
    launches = run["launches"]
    c, f = stats["crossings"].astype(float), stats["intra_fraction"]
    say(f"exchange cell ({run['engine']}): closed cylinder mesh, perm 0.2, "
        f"{n} intra spins x {n_t} steps in {run['wall_s']:.2f} s; "
        f"{launches['fused_epoch']} fused_epoch and {launches['mesh_hit']} "
        f"mesh_hit launches; weight identity |S - sum w| / sum w = "
        f"{parity.results['fused_exchange_weight_consistency']['value']:.3g}"
        f" (limit 1e-4); mean crossings {c.mean():.5f} (PARITY_r05 on the "
        f"TPU: 10.60821), mean intra fraction {f.mean():.5f}; "
        f"fused_exchange_rate_nonzero: 1 / mean crossings = "
        f"{parity.results['fused_exchange_rate_nonzero']['value']:.5f} "
        "(limit 10)")
    if not (run["engine"] == "fused" and launches["fused_epoch"] > 0
            and launches["mesh_hit"] == 0):
        raise AssertionError("the tracked fused run must launch fused_epoch "
                             "only")
    try:
        config.use_fused = False
        (sig, stats_c), run_c = parity.simulate(
            n, DIFFUSIVITY, np.zeros((1, n_t, 3)), dt, sub, seed=7,
            relaxation=T2_PAIR, exchange_stats=True)
    finally:
        config.use_fused = None
    gap = _weight_gap(sig[0], stats_c["intra_steps"], n_t, dt)
    launches = run_c["launches"]
    say(f"exchange cell (classic): {n} intra spins x {n_t} steps in "
        f"{run_c['wall_s']:.2f} s; {launches['fused_epoch']} fused_epoch and "
        f"{launches['mesh_hit']} mesh_hit launches; weight identity "
        f"{gap:.3g} (limit 1e-4)")
    if not (launches["mesh_hit"] > 0 and launches["fused_epoch"] == 0):
        raise AssertionError("the tracked classic run must launch mesh_hit "
                             "only")
    if not gap <= 1e-4:
        raise AssertionError("classic: relaxation weights do not match the "
                             "dwell steps")
    for name, a, b in (
            ("mean crossings", c, stats_c["crossings"].astype(float)),
            ("mean intra fraction", f, stats_c["intra_fraction"])):
        se = math.sqrt(a.var() / len(a) + b.var() / len(b))
        gap = abs(float(a.mean() - b.mean()))
        say(f"fused vs classic {name}: {a.mean():.5f} vs {b.mean():.5f}, "
            f"|diff| = {gap / se:.2f} standard errors (limit 4)")
        if not gap <= 4 * se:
            raise AssertionError(f"fused and classic {name} disagree")

    stats, run = runs["sphere"]
    say(f"permeable sphere ({run['engine']}): r 5 um, perm 0.3, {n} spins x "
        f"{n_t} steps in {run['wall_s']:.2f} s; weight identity "
        f"{parity.results['perm_sphere_weight_consistency']['value']:.3g} "
        f"(limit 1e-4); fraction outside "
        f"{parity.results['perm_sphere_escape']['frac_outside']:.5f} "
        f"(perm_sphere_escape 1 - that, limit 1; the JAX package on the "
        f"TPU: 0.97771 outside); mean crossings "
        f"{stats['crossings'].mean():.5f}")
    say(f"uniform_t2_exact: free, 2e4 spins x 500 steps x 10 b, max "
        f"|S_T2 / S - exp(-T / T2)| = "
        f"{parity.results['uniform_t2_exact']['value']:.3g} (limit 1e-5)")
    _require(parity, "fused_exchange_weight_consistency",
             "fused_exchange_rate_nonzero", "perm_sphere_weight_consistency",
             "perm_sphere_escape", "uniform_t2_exact")


def tracked_window():
    """Phase 12: the tracked fused window, kernel against plain version,
    from the same 16,384 intra starts of the exchange cell (20 steps, 5
    epochs). Crossings and intra steps must be equal for every spin whose
    positions agree (within 1e-4 step lengths); at most 0.5% may
    diverge."""
    from disimpy_tpu_torch import simulations
    from disimpy_tpu_torch.engine import (config, fused, fused_kernel,
                                          launch_count)

    n, n_t, dt = 16384, 20, 2e-4
    sub = _exchange_cylinder()
    scale = 1.0 / math.sqrt(6 * DIFFUSIVITY * dt)
    start = simulations._fill_mesh(n, sub, True, 11, "cuda")
    spec = simulations._fused_spec(sub, n, scale, torch.device("cuda"))
    eps = simulations._effective_epsilon(
        1e-13, scale, float(np.max(sub.voxel_size)) * scale, n_t,
        torch.float32, False)
    pos0 = torch.as_tensor(start.T * scale, dtype=torch.float32,
                           device="cuda")

    def run():
        zeros = torch.zeros(n, dtype=torch.int32, device="cuda")
        comp = (zeros, torch.ones(n, dtype=torch.bool, device="cuda"), zeros)
        return fused.run_window_fused(
            spec, pos0, torch.zeros((1, n), device="cuda"),
            torch.zeros(n, dtype=torch.bool, device="cuda"),
            torch.zeros((n_t, 1, 3), device="cuda"), range(n_t), 11, eps,
            1000, track=True, compartments=comp)

    launch_count.reset()
    kp, _, _, (kc, _, ki) = run()
    launched = launch_count.counts["fused_epoch"]
    # The plain version's run is eager: a replay of the graph the kernel's
    # run captured would launch the kernel again.
    kernel = fused_kernel.fused_epoch
    fused_kernel.fused_epoch = fused_kernel.fused_epoch_reference
    config.fused_cuda_graph = False
    try:
        pp, _, _, (pc, _, pi) = run()
    finally:
        fused_kernel.fused_epoch = kernel
        config.fused_cuda_graph = True
    diverged = (kp - pp).abs().amax(dim=0) > 1e-4
    differ = (kc != pc) | (ki != pi)
    frac = float(diverged.float().mean())
    say(f"tracked window, kernel vs plain: {n} intra spins x {n_t} steps, "
        f"{launched} kernel launches; crossings {int(kc.sum())} / "
        f"{int(pc.sum())}, intra steps {int(ki.sum())} / {int(pi.sum())}; "
        f"{int(differ.sum())} spins with other counts, "
        f"{int((differ & ~diverged).sum())} of them with agreeing positions; "
        f"divergent fraction {frac:.6f} (limit 0.005)")
    if launched != math.ceil(n_t / spec.resort_every):
        raise AssertionError(f"{launched} kernel launches in the tracked window")
    if bool((differ & ~diverged).any()) or frac > 0.005:
        raise AssertionError("the tracked window's counts differ from the "
                             "plain version's")


def tracked_bench(bench, smi, fused_runs):
    """Phase 13: the bench workload with exchange_stats=True: the
    classification of the uniform starts on the card, the tracked run
    beside an untracked one with the same seed (equal positions and signals
    bit for bit) and phase 6's timed run."""
    from disimpy_tpu_torch import simulations
    from disimpy_tpu_torch.engine import launch_count

    sub, step_l = bench["substrate"], bench["step_l"]
    scale = 1.0 / step_l
    n, n_t, seed = 524288, 150, 2
    vox = np.asarray(sub.voxel_size) * scale

    timing = {}
    start_parity = simulations._start_parity

    def timed_parity(*args):
        t = time.perf_counter()
        out = start_parity(*args)
        timing["classify"] = time.perf_counter() - t
        return out

    runs = {}
    simulations._start_parity = timed_parity
    try:
        for label, track in (("untracked", False), ("tracked", True)):
            launch_count.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = simulations.simulation(
                n, DIFFUSIVITY, bench["gradient"], bench["dt"], sub,
                seed=seed, quiet=True, final_pos=True, exchange_stats=track,
                device="cuda")
            torch.cuda.synchronize()
            runs[label] = (time.perf_counter() - t0,
                           launch_count.counts["fused_epoch"], out)
    finally:
        simulations._start_parity = start_parity
    wall, launched, (sig_t, pos_t, stats) = runs["tracked"]
    wall_u, launched_u, (sig_u, pos_u) = runs["untracked"]
    intra = stats["intra_steps"]
    fraction = float((intra == n_t).mean())
    pos0 = simulations._uniform_positions(n, vox, seed, "cuda")
    d0 = _nearest(pos0.cpu().numpy().T[:, :2].astype(float) * step_l,
                  *_bundle_axes(bench))
    r = bench["radius"]
    lo, hi = r * math.cos(math.pi / 32) * (1 - 1e-4), r * (1 + 1e-4)
    wrong = int((((d0 < lo) & (intra != n_t)) | ((d0 > hi) & (intra != 0)))
                .sum())
    same = np.array_equal(pos_t, pos_u) and np.array_equal(sig_t, sig_u)
    say(f"tracked bench: {n} spins x {n_t} steps x 32 meas, "
        f"exchange_stats=True in {wall:.3f} s, of which the classification "
        f"of the starts on the card {timing['classify']:.3f} s; untracked "
        f"{wall_u:.3f} s; phase 6 "
        f"timed run {fused_runs['timed']['wall']:.3f} s ({smi}); "
        f"{launched} / {launched_u} kernel launches; crossings total "
        f"{int(stats['crossings'].sum())}; intra fraction {fraction:.6f}; "
        f"{wrong} starts whose parity contradicts their distance to the "
        f"nearest axis (limit {MAX_MISCLASSIFIED * n:g}); positions and signals "
        f"{'equal bit for bit' if same else 'DIFFERENT'} to the untracked run")
    expected = math.ceil(n_t / bench["spec"].resort_every)
    if launched != expected or launched_u != expected:
        raise AssertionError("the bench runs did not launch the kernel once "
                             "per epoch")
    if stats["crossings"].any() or not np.all((intra == 0) | (intra == n_t)):
        raise AssertionError("the impermeable bundle reported transits")
    # The start classifier is the reference's float32 +x-ray parity: a ray
    # that grazes a facet edge within float32 rounding counts both facets
    # (seed 2 at 524,288 spins: one start, 1e-13 m from an edge).
    if wrong > MAX_MISCLASSIFIED * n or not same:
        raise AssertionError("tracking changed a walk or misclassified starts")
    return dict(n=n, wall=wall, classify=timing["classify"], untracked=wall_u)


def split_and_sweeps():
    """Phase 14: runs split over two parts on one card against the single
    run (fused exchange cell and permeable analytic sphere, 1e5 spins x 40
    steps), and a sphere radius sweep against its standalone runs."""
    from disimpy_tpu_torch import simulations, substrates, sweeps
    from disimpy_tpu_torch.engine import launch_count

    n, n_t, dt = 100000, 40, 2e-4
    g0 = np.zeros((1, n_t, 3))
    for label, sub in (("fused exchange cell", _exchange_cylinder()),
                       ("classic permeable sphere",
                        substrates.sphere(5e-6, perm_prob=0.3))):
        out = {}
        for devices in (None, ["cuda:0", "cuda:0"]):
            launch_count.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = simulations.simulation(
                n, DIFFUSIVITY, g0, dt, sub, quiet=True, seed=7,
                final_pos=True, relaxation=T2_PAIR, exchange_stats=True,
                devices=devices, device=None if devices else "cuda")
            torch.cuda.synchronize()
            out[devices is None] = (time.perf_counter() - t0,
                                    launch_count.counts["fused_epoch"],
                                    launch_count.counts["mesh_hit"], res)
        (w1, f1, m1, (s1, p1, st1)), (w2, f2, m2, (s2, p2, st2)) = (
            out[True], out[False])
        equal = (np.array_equal(p1, p2)
                 and np.array_equal(st1["crossings"], st2["crossings"])
                 and np.array_equal(st1["intra_steps"], st2["intra_steps"]))
        rel = float(np.abs(s2 - s1).max() / np.abs(s1).max())
        say(f"split ({label}): {n} spins x {n_t} steps, one part {w1:.2f} s "
            f"({f1} fused_epoch / {m1} mesh_hit launches), two parts on "
            f"cuda:0 {w2:.2f} s ({f2} / {m2}); positions, crossings and "
            f"intra steps {'equal' if equal else 'DIFFERENT'} per spin; "
            f"signals {rel:.3g} relative (limit 1e-6)")
        if not (equal and rel <= 1e-6):
            raise AssertionError(f"the split {label} differs from one part")
        if label.startswith("fused") and not (f1 > 0 and f2 > 0):
            raise AssertionError("the split fused runs did not launch "
                                 "fused_epoch")

    gradient, dt = _misst_gradient(30)
    radii = np.array([2e-6, 4e-6, 6e-6, 8e-6])
    n = 10000
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    swept = sweeps.sweep_sphere_radii(n, DIFFUSIVITY, gradient, dt, radii,
                                      device="cuda")
    t_sweep = time.perf_counter() - t0
    t0 = time.perf_counter()
    singles = np.stack([
        simulations.simulation(n, DIFFUSIVITY, gradient, dt,
                               substrates.sphere(float(r)), quiet=True,
                               device="cuda")
        for r in radii
    ])
    t_single = time.perf_counter() - t0
    diff = float(np.abs(swept - singles).max())
    ok = np.allclose(swept, singles, rtol=1e-6, atol=1e-5)
    say(f"sphere radius sweep: radii 2/4/6/8 um, {n} spins x 1000 steps x "
        f"100 b in {t_sweep:.2f} s; the four standalone runs {t_single:.2f} "
        f"s; max |sweep - standalone| = {diff:.3g} "
        f"({'within' if ok else 'OUTSIDE'} rtol 1e-6, atol 1e-5)")
    if not ok:
        raise AssertionError("a sweep row differs from its standalone run")


def parity_matrix(parity):
    """Phase 15: the PARITY_r05 checks no other phase runs, through
    scripts/parity_torch.py: the closed cylinder mesh over {periodic} x
    {padding} x {n_sv} against MISST with its radial leak checks (all 24,
    two of them phase 5's), and the neuron leak check at dt 1e-5 (the
    cheapest neuron pack; parity_torch.py runs all three step sizes).
    Every check that ``parity`` holds (phases 4, 5, 8 and 11 ran theirs
    through it) must meet its threshold, every fused run must launch the
    epoch kernel, and each (periodic, padding) pair's three n_sv runs are
    compared bit for bit. One epoch of the kernel is held to its plain
    version on the non-periodic padded run's pack (:func:`_epoch_vs_plain`).
    """
    from disimpy_tpu_torch.simulations import _effective_epsilon

    parity_torch = _parity_torch()
    parity.mesh()
    # One epoch of the kernel against its plain version on the pack the
    # non-periodic padded run used: uniform spins fill the boundary cells,
    # whose rows hold the voxel-wall triangles.
    key = parity_torch.mesh_key(False, 1, parity_torch.MESH_NSV[-1])
    sub = parity.substrates[key]
    (_, scale, *_), spec = next((k, v) for k, v in sub._accel_cache.items()
                                if k[0] == "fused-torch")
    eps = _effective_epsilon(1e-13, scale,
                             float(np.max(sub.voxel_size)) * scale, 1000,
                             torch.float32, True)
    _say_epoch(f"kernel vs plain, {key} pack: 65536 uniform spins x "
               f"J={spec.resort_every}", _epoch_vs_plain(spec, 65536, eps))
    parity.neuron(dts=(1e-5,))
    failed = [k for k, v in parity.results.items() if not v["pass"]]
    idle = [k for k, v in parity.results.items()
            if v.get("engine") == "fused" and v["launches"]["fused_epoch"] < 1]
    for pair, diff in parity.meta["nsv_signal_max_abs_diff"].items():
        say(f"parity matrix, {pair}: the signals of the n_sv runs "
            f"{', '.join('x'.join(map(str, v)) for v in parity_torch.MESH_NSV)}"
            + (" are equal bit for bit" if diff == 0 else
               f" differ by up to {diff:.3g} (of {parity.n(1e4)} spins): the "
               "fused pack does not depend on n_sv, so only the seeding's "
               "column candidates could differ"))
    say(f"parity matrix: {len(parity.results)} of the "
        f"{len(parity_torch.matrix())} PARITY_r05 checks run in phases 4, 5, "
        f"8, 11 and 15, {len(parity.results) - len(failed)} within their "
        "thresholds")
    if failed or idle:
        raise AssertionError(f"parity checks failed: {failed}; fused runs "
                             f"without kernel launches: {idle}")
    return parity.results


def _neuron_substrate():
    """bench.py's neuron workload substrate: the reference's neuron mesh
    (29,688 triangles), periodic, the default n_sv."""
    from disimpy_tpu_torch import substrates

    with open(os.path.join(ORACLES, "neuron-model.pkl"), "rb") as f:
        mesh = pickle.load(f)
    return substrates.mesh(np.asarray(mesh["vertices"], dtype=np.float64),
                           np.asarray(mesh["faces"]), periodic=True,
                           quiet=True)


def _counted_run(sub, n, n_t, dt, seed):
    """A run of n spins x n_t steps (bench.py's 32-measurement waveform),
    with the kernel's counting variant and without: (the counts, kernel
    launches of the counted run, whether positions and signals are equal
    bit for bit)."""
    from disimpy_tpu_torch import gradients, simulations
    from disimpy_tpu_torch.engine import config, launch_count

    bvals = np.linspace(1e8, 3e9, 32)
    bvecs = np.tile(np.array([[1.0, 0.0, 0.0]]), (32, 1))
    gradient, _ = gradients.pgse(1e-3, dt * n_t - 1e-3, n_t, bvals, bvecs)
    out = {}
    for counting in (True, False):
        config.fused_count_units = counting
        launch_count.reset()
        try:
            out[counting] = simulations.simulation(
                n, DIFFUSIVITY, gradient, dt, sub, seed=seed, quiet=True,
                final_pos=True, device="cuda")
        finally:
            config.fused_count_units = False
        if counting:
            diag = list(simulations._STREAM_DIAG)
            launched = launch_count.counts["fused_epoch"]
    same = all(np.array_equal(a, b) for a, b in zip(out[True], out[False]))
    return diag, launched, same


def neuron_workload(bench, smi):
    """Phase 16: bench.py's neuron workload through simulation(): the cold
    pack, one epoch of the kernel against its plain version on its table
    (:func:`_epoch_vs_plain`), a warm-up and a timed run of 524,288 spins x
    150 steps x 32
    measurements, kernel launches, finite signals; then 32-step counting
    runs on the neuron and on the bundle (bench.py --stream), each equal
    bit for bit to the same run without counting."""
    from disimpy_tpu_torch import simulations
    from disimpy_tpu_torch.engine import launch_count

    n, n_t, dt = 524288, 150, bench["dt"]
    step_l = bench["step_l"]
    sub = _neuron_substrate()
    t0 = time.perf_counter()
    spec = simulations._fused_spec(sub, n, 1.0 / step_l, torch.device("cuda"))
    t_pack = time.perf_counter() - t0
    if spec is None:
        raise AssertionError("no fused table fits the neuron workload")
    # One epoch of K1 alone, from uniform starts sorted as the driver sorts
    # them: the kernel's share of a run.
    eps = simulations._effective_epsilon(
        1e-13, 1.0 / step_l, float(np.max(sub.voxel_size)) / step_l, n_t,
        torch.float32, False)
    epoch = _epoch_vs_plain(spec, n, eps)
    k1_ms = epoch["ms"]
    expected = math.ceil(n_t / spec.resort_every)
    say(f"neuron pack: {len(sub.faces)} triangles, voxel "
        f"{np.round(np.asarray(sub.voxel_size) * 1e6, 2).tolist()} um, "
        f"pack_fused {t_pack:.1f} s host (cold), J={spec.resort_every}, "
        f"n_sv={spec.n_sv}, table {spec.table.numel() * 4 / 1e6:.1f} MB; K1 "
        f"{k1_ms:.4f} ms per epoch on {n} sorted uniform spins (plain "
        f"{epoch['plain_ms']:.2f} ms), {expected * k1_ms:.1f} ms per run of "
        f"{expected} epochs")
    _say_epoch(f"kernel vs plain, neuron pack: {n} spins x "
               f"J={spec.resort_every}", epoch)
    runs = {}
    for label, seed in (("warm-up", 1), ("timed", 2)):
        launch_count.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        signals = simulations.simulation(
            n, DIFFUSIVITY, bench["gradient"], dt, sub, seed=seed,
            quiet=True, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = launch_count.counts["fused_epoch"]
        say(f"neuron {label}: {n} spins x {n_t} steps x 32 meas in "
            f"{wall:.3f} s = {n * n_t / wall:.6g} spin-steps/s ({smi}); "
            f"{launched} kernel launches; signals "
            f"{'finite' if np.all(np.isfinite(signals)) else 'NOT finite'}")
        if launched != expected or not np.all(np.isfinite(signals)):
            raise AssertionError(f"neuron {label}: {launched} launches "
                                 f"(expected {expected}) or non-finite "
                                 "signals")
        runs[label] = dict(wall=wall, launches=launched)
    runs["k1_ms"] = k1_ms
    n_c = 32
    for label, s in (("neuron", sub), ("bundle", bench["substrate"])):
        J = simulations._fused_spec(s, n, 1.0 / step_l,
                                    torch.device("cuda")).resort_every
        diag, launched, same = _counted_run(s, n, n_c, dt, seed=3)
        units, passes, issued = diag
        say(f"counting run ({label}): {n} spins x {n_c} steps, {launched} "
            f"kernel launches; triangles tested per spin-step "
            f"{64 * units / (n * n_c):.2f}, bounce passes per spin-step "
            f"{passes / (n * n_c):.4f}, fold-lane efficiency "
            f"{units / issued:.4f} (units folded {units}, passes {passes}, "
            f"units issued {issued}); positions and signals "
            f"{'equal bit for bit' if same else 'DIFFERENT'} without "
            "counting")
        if not (same and 0 < units <= issued
                and launched == math.ceil(n_c / J)):
            raise AssertionError(f"counting run ({label}) failed")
        runs[label + " counts"] = diag
    runs.update(substrate=sub, spec=spec, pack_s=t_pack)
    return runs


# Epoch lengths phase 17 sweeps (1..engine.fused.MAX_J), and how many
# readings of K1's time per epoch it takes at each.
SWEEP_J = (1, 2, 3, 4, 5)
SWEEP_READINGS = 5


def _sweep_widths(spec, sub, scale):
    """The cell widths either side of the one the pack's search chose on
    its ladder (1.5 x the widest when it chose the widest)."""
    from disimpy_tpu_torch.engine import fused

    voxel = np.asarray(sub.voxel_size, dtype=np.float64) * scale
    ladder = fused.WIDTH_LADDER
    i = next(k for k, w in enumerate(ladder) if tuple(
        int(x) for x in np.maximum(1, np.floor(voxel / w))) == spec.n_sv)
    return (ladder[i - 1] if i else 1.5 * ladder[0]), ladder[i + 1]


def _counting_build():
    """Wraps ``fused._build_table`` to count the tables built: returns (the
    list it appends to, a function that restores it)."""
    from disimpy_tpu_torch.engine import fused

    built, build_table = [], fused._build_table

    def counted(*args):
        built.append(1)
        return build_table(*args)

    fused._build_table = counted
    return built, lambda: setattr(fused, "_build_table", build_table)


def _bundle_pack(J, width):
    """Phase 17's bundle pack at (J, width), in a worker process: it fills
    the pack's disk cache, which the main process reads. Returns (host
    seconds, tables built: 0 when the disk cache served it)."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from disimpy_tpu_torch.engine import fused

    built, restore = _counting_build()
    sub, _, _ = _bundle_substrate()
    t0 = time.perf_counter()
    try:
        fused.pack_fused(sub, 1.0 / BUNDLE_STEP, resort_every=J,
                         cell_steps=width, n_hint=524288.0)
    except ValueError:
        pass  # no table fits: the main process finds the cached failure
    finally:
        restore()
    return time.perf_counter() - t0, len(built)


class _Packer:
    """Phase 17's bundle packs, one after another in one worker process
    (one BLAS thread), started after phase 13 so that their host time
    passes beside phases 14-16 on one of the host's cores."""

    def __init__(self, points):
        import multiprocessing

        names = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
        saved = {k: os.environ.get(k) for k in names}
        os.environ.update({k: "1" for k in names})
        try:
            self.pool = multiprocessing.get_context("spawn").Pool(1)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
        self.jobs = {p: self.pool.apply_async(_bundle_pack, p)
                     for p in points}

    def result(self, point):
        return self.jobs[point].get()

    def stop(self):
        self.pool.terminate()
        self.pool.join()


def _sweep_point(label, sub, step_l, gradient, dt, smi, J, width, cold):
    """One (J, width) of phase 17 on one workload: the pack, K1 against
    its plain version on 16,384 spins, K1's time per epoch at 524,288, a
    warm-up and a timed run, a 32-step counting run and K1's bound from its
    counts. ``cold`` is (host seconds, where) of a cold pack made before,
    or None to pack here. Returns the record."""
    from disimpy_tpu_torch import simulations
    from disimpy_tpu_torch.engine import (config, fused, fused_kernel,
                                          launch_count)

    n, n_t, n_c = 524288, 150, 32
    scale = 1.0 / step_l
    config.fused_resort_every, config.fused_cell_steps = J, width
    built, restore = _counting_build()
    try:
        t0 = time.perf_counter()
        spec = simulations._fused_spec(sub, n, scale, torch.device("cuda"))
        t_load = time.perf_counter() - t0
    finally:
        restore()
    knob = f"J={J}" + ("" if width is None else f", width {width} steps")
    if spec is None:
        raise AssertionError(f"sweep {label}, {knob}: no fused table fits")
    pack_s, where = cold or (t_load, "here")
    if not cold and not built:
        where = "here, from a cache"
    J_run = spec.resort_every
    eps = simulations._effective_epsilon(
        1e-13, scale, float(np.max(sub.voxel_size)) * scale, n_t,
        torch.float32, False)
    mb = spec.table.numel() * 4 / 1e6
    say(f"sweep {label}, {knob}: pack {pack_s:.2f} s host ({where}), "
        f"{t_load:.2f} s to serve it to simulation(); J requested {J}, "
        f"chosen {J_run}; n_sv {spec.n_sv}, {spec.table.shape[0]} units, "
        f"table {mb:.1f} MB")
    epoch = _epoch_vs_plain(spec, 16384, eps, exact=True)
    _say_epoch(f"sweep {label}, {knob}: kernel vs plain, 16384 spins x "
               f"J={J_run}", epoch)
    inputs, seed_k = _sorted_epoch_inputs(spec, n, seed=11)
    args = (spec, *inputs, 0, J_run, seed_k, eps, 1000)
    readings = sorted(
        _cuda_ms(lambda: fused_kernel.fused_epoch(*args), 20)[0]
        for _ in range(SWEEP_READINGS))
    del inputs, args
    expected = math.ceil(n_t / J_run)
    walls = {}
    for run, seed in (("warm-up", 1), ("timed", 2)):
        launch_count.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        signals = simulations.simulation(
            n, DIFFUSIVITY, gradient, dt, sub, seed=seed, quiet=True,
            device="cuda")
        torch.cuda.synchronize()
        walls[run] = time.perf_counter() - t0
        launched = launch_count.counts["fused_epoch"]
        finite = bool(np.all(np.isfinite(signals)))
        if launched != expected or not finite:
            raise AssertionError(
                f"sweep {label}, {knob}, {run}: {launched} launches "
                f"(expected {expected}), signals finite: {finite}")
    diag, launched_c, same = _counted_run(sub, n, n_c, dt, seed=3)
    units, passes, issued = diag
    if not (same and 0 < units <= issued
            and launched_c == math.ceil(n_c / J_run)):
        raise AssertionError(f"sweep {label}, {knob}: counting run failed")
    # K1's bound per epoch from the counting run: each launch reads the
    # table once and each spin's inputs and outputs (as _epoch_vs_plain
    # counts them), and folds its share of the run's units.
    n_bytes = (spec.table.numel() * 4 + n * (4 * (6 + 3 * J_run) + 16)
               + n * (16 * J_run + 1))
    flops = units * fused.UNIT_TRIS * fused_kernel.FLOPS_PER_TRIANGLE
    bound_ms, bound_by = bound(n_bytes, flops / launched_c)
    median = readings[len(readings) // 2]
    rate = n * n_t / walls["timed"]
    say(f"sweep {label}, {knob}: K1 {median:.4f} ms per epoch (median of "
        f"{SWEEP_READINGS} readings of 20 calls, {readings[0]:.4f}-"
        f"{readings[-1]:.4f}) at {n} sorted uniform spins; runs {n} x {n_t} "
        f"x 32 meas: warm-up {walls['warm-up']:.3f} s, timed "
        f"{walls['timed']:.3f} s = {rate:.6g} spin-steps/s ({smi}), "
        f"{expected} K1 launches each, signals finite; {n_c}-step counting "
        f"run: {64 * units / (n * n_c):.2f} triangles tested per spin-step, "
        f"{passes / (n * n_c):.4f} bounce passes per spin-step, fold-lane "
        f"efficiency {units / issued:.4f}, equal bit for bit without "
        f"counting; bound {bound_ms:.4f} ms per epoch ({bound_by}: "
        f"{flops / launched_c:.4g} flops, {n_bytes / 1e6:.1f} MB), lost per "
        f"run {expected * (median - bound_ms):.1f} ms")
    return dict(workload=label, J=J, width=width, J_run=J_run,
                n_sv=list(spec.n_sv), units=int(spec.table.shape[0]),
                table_mb=mb, pack_s=pack_s, pack_where=where,
                divergent=epoch["divergent"], k1_ms_16384=epoch["ms"],
                plain_ms_16384=epoch["plain_ms"], ms=median,
                ms_range=[readings[0], readings[-1]], launches=expected,
                warm_s=walls["warm-up"], timed_s=walls["timed"],
                spin_steps_per_s=rate,
                tris_per_spin_step=64 * units / (n * n_c),
                passes_per_spin_step=passes / (n * n_c),
                efficiency=units / issued, bound_ms=bound_ms,
                bound_by=bound_by, lost_ms=expected * (median - bound_ms))


def sweep_points(spec, sub, scale):
    """Phase 17's (J, width) points: J = 1..5 with the search, and J = 4
    at the two cell widths either side of the searched one."""
    return ([(J, None) for J in SWEEP_J]
            + [(4, w) for w in _sweep_widths(spec, sub, scale)])


def knob_sweep(bench, neuron, smi, packer):
    """Phase 17: the fused engine's epoch length J (1..5) and two fixed cell
    widths either side of the searched one (``config.fused_resort_every``,
    ``config.fused_cell_steps``), on the bench bundle and the neuron, each
    through ``simulation()`` at full width (:func:`_sweep_point`). The
    bundle's packs come from ``packer`` (the default one from phase 2),
    the neuron's are made here (the default one in phase 16). Any J whose
    K1 diverges from its plain version past the limit, or whose run is not
    finite, fails the phase."""
    from disimpy_tpu_torch.engine import config

    step_l, dt = bench["step_l"], bench["dt"]
    scale = 1.0 / step_l
    records = []
    try:
        for label, (sub, spec, pack_s, phase) in (
                ("bundle", (bench["substrate"], bench["spec"],
                            bench["pack_s"], "phase 2")),
                ("neuron", (neuron["substrate"], neuron["spec"],
                            neuron["pack_s"], "phase 16"))):
            for J, width in sweep_points(spec, sub, scale):
                if (J, width) == (4, None):
                    cold = (pack_s, phase)
                elif label == "bundle":
                    seconds, built = packer.result((J, width))
                    cold = (seconds, "in a worker process beside phases "
                            "14-16" + ("" if built else ", from a cache"))
                else:
                    cold = None
                records.append(_sweep_point(label, sub, step_l,
                                            bench["gradient"], dt, smi, J,
                                            width, cold))
    finally:
        config.fused_resort_every, config.fused_cell_steps = 4, None
    say("k1 sweep: " + json.dumps(records))
    return records


# The H100 SXM's int32 rate: 64 INT32 lanes per SM (NVIDIA's Hopper
# architecture white paper) x 132 SMs x 1.98 GHz boost clock. K7's cipher
# is integer work, which the guide's floating-point peaks do not cover.
PEAK_FLOPS["int32"] = 64 * 132 * 1.98e9
# Integer instructions of one spin-step of K7's directions, counted from
# csrc/threefry.cuh as sm_90 SASS issues them: 13 rounds of add, rotate
# (one funnel shift) and xor (39), where the x0 key injections fold into
# the next round's add (one IADD3); the three x1 injections, one IADD3
# each with their constant (3); the step's key word and the key schedule
# (2); the two 8-bit shifts of the uniforms (2). All 46 are charged to
# the INT32 lanes, though adds may also issue on the FMA pipe: the bound
# this gives is below the bytes' in every case the smoke measures, so the
# bound is the bytes'.
K7_INT_OPS = 46
# Readings of each run in the graph-against-eager comparison.
GRAPH_READINGS = 5


def _sass_tally(path, function):
    """Counts of each SASS mnemonic in the kernel of the library ``path``
    whose mangled name contains ``function`` (``cuobjdump -sass``), or
    None where cuobjdump is missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    dump = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    # An instruction: its offset, an optional predicate, the mnemonic.
    insn = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)")
    tally, inside = collections.Counter(), False
    for line in dump.splitlines():
        if "Function :" in line:
            inside = function in line
        elif inside:
            m = insn.search(line)
            if m:
                tally[m.group(1)] += 1
    return tally


def _draw_check():
    """K7 against its plain version (``engine/krng.py``'s torch operators
    on the card) at 524,288 spins: directions at J = 1..5 in float32 and
    float64, and the bounce uniforms (all spins at one bounce index, and a
    gathered subset at per-spin indices). Every float must be equal bit
    for bit. Also times each against the plain version and its bound, and
    tallies the integer instructions of the float32 directions kernel."""
    from disimpy_tpu_torch.engine import _build, draw_kernel, krng

    n = 524288
    rng = np.random.RandomState(5)
    ids_np = rng.randint(-2**31, 2**31, size=n, dtype=np.int64).astype(
        np.int32)
    ids_np[:3] = (0, -1, 2**31 - 1)
    ids = torch.from_numpy(ids_np).cuda()
    seed, t_base = -1234567, 37
    scal = draw_kernel.device_scalars((seed, t_base), "cuda")
    record = {}
    for dtype in (torch.float32, torch.float64):
        size = torch.empty((), dtype=dtype).element_size()
        for J in (1, 2, 3, 4, 5):
            kernel = draw_kernel.directions_cuda(scal[0], scal[1], J, ids,
                                                 dtype)
            plain = krng.unit_directions_epoch(seed, t_base, J, ids, dtype)
            differ = int((kernel != plain).sum())
            err = float((kernel - plain).abs().max())
            ms = _graph_ms(lambda: draw_kernel.directions_cuda(
                scal[0], scal[1], J, ids, dtype), 50)
            plain_ms, _ = _cuda_ms(lambda: krng.unit_directions_epoch(
                seed, t_base, J, ids, dtype), 5)
            bound_ms, bound_by = bound(3 * J * n * size + 4 * n + 8,
                                       K7_INT_OPS * J * n, "int32")
            say(f"krng_draw directions, {str(dtype)[6:]}, J={J}, {n} spins: "
                f"{differ} of {kernel.numel()} floats differ from the plain "
                f"version (largest difference {err:.3g}); kernel {ms:.4f} "
                f"ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by})")
            if differ:
                raise AssertionError(
                    f"krng_draw directions ({dtype}, J={J}) differ from the "
                    "plain version")
            record[str(dtype)[6:], J] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)
        idx = torch.from_numpy(rng.permutation(n)[:n // 8]).cuda()
        bounce = torch.from_numpy(
            rng.randint(0, 50, size=n // 8).astype(np.int32)).cuda()
        pairs = (
            (draw_kernel.uniforms_cuda(scal[0], scal[1], ids, 3, None, dtype),
             krng.bounce_uniform(seed, t_base, ids, 3, dtype)),
            (draw_kernel.uniforms_cuda(seed, t_base, ids, bounce, idx, dtype),
             krng.bounce_uniform(seed, t_base, ids[idx], bounce, dtype)),
        )
        if not all(torch.equal(a, b) for a, b in pairs):
            raise AssertionError(f"krng_draw uniforms ({dtype}) differ from "
                                 "krng.bounce_uniform")
        ms = _graph_ms(lambda: draw_kernel.uniforms_cuda(
            scal[0], scal[1], ids, 3, None, dtype), 50)
        say(f"krng_draw uniforms, {str(dtype)[6:]}: equal to "
            f"krng.bounce_uniform bit for bit on {n} spins at one bounce "
            f"index and on {n // 8} gathered spins at per-spin indices; "
            f"{ms:.4f} ms for {n}")
    tally = _sass_tally(_build.load("krng_draw").path, "directions_kernelIf")
    say("krng_draw SASS of directions_kernel<float>: " + (
        "not measured (no cuobjdump)" if tally is None else
        f"{sum(tally.values())} instructions; integer and conversion: "
        + ", ".join(f"{k} {tally[k]}" for k in (
            "IADD3", "SHF", "LOP3", "IMAD", "SHL", "SHR", "I2F", "I2FP"))
        + "; largest: " + ", ".join(
            f"{k} {v}" for k, v in tally.most_common(8))))
    return record


def _window_inputs(sub, step_l, gradient, dt, n, seed):
    """A bench-shaped fused window's arguments: uniform starts, the run's
    g_eff, its effective epsilon, random start parities."""
    from disimpy_tpu_torch import gradients, simulations

    scale = 1.0 / step_l
    n_t = gradient.shape[1]
    spec = simulations._fused_spec(sub, n, scale, torch.device("cuda"))
    pos0 = simulations._uniform_positions(
        n, np.asarray(sub.voxel_size) * scale, seed, "cuda")
    g_eff = torch.as_tensor(
        (gradients.GAMMA * dt * step_l) * np.transpose(gradient, (1, 0, 2)),
        dtype=torch.float32, device="cuda")
    eps = simulations._effective_epsilon(
        1e-13, scale, float(np.max(sub.voxel_size)) * scale, n_t,
        torch.float32, False)
    parity = torch.from_numpy(
        np.random.RandomState(seed).random_sample(n) < 0.5).cuda()
    return spec, pos0, g_eff, eps, parity


def _window(spec, pos0, g_eff, eps, parity, seed, track):
    from disimpy_tpu_torch.engine import fused

    n = pos0.shape[1]
    zeros = torch.zeros(n, dtype=torch.int32, device="cuda")
    return fused.run_window_fused(
        spec, pos0, torch.zeros((g_eff.shape[1], n), device="cuda"),
        torch.zeros(n, dtype=torch.bool, device="cuda"), g_eff,
        range(g_eff.shape[0]), seed, eps, 1000, track=track,
        compartments=(zeros, parity, zeros) if track else None)


def _flat(out):
    """The tensors of a window's nested outputs, in order (None skipped)."""
    flat = []
    for o in out:
        if isinstance(o, tuple):
            flat.extend(_flat(o))
        elif o is not None:
            flat.append(o)
    return flat


def _busy_share(run, origins=False):
    """One profiled call of ``run``: (device busy ms, wall ms, CUDA kernels
    and copies seen, the four names with the most device time as (name,
    ms, count), {name: count} of every device event, and {name: (ms,
    count, origin)} of every device event); busy time sums each device
    event's own time (one stream, so they do not overlap). With
    ``origins`` (an eager run: a graph replay launches from no operator)
    each kernel's origin is the chain of operators that most often
    launched it, innermost first; otherwise None."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    device = [e for e in events if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in device) / 1e3
    by_name = {}
    for e in device:
        ms, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.self_device_time_total / 1e3, count + 1)
    chains = collections.defaultdict(collections.Counter)
    if origins:
        for e in events:
            if e.device_type.name != "CPU" or not e.kernels:
                continue
            chain, p = [], e
            while p is not None and len(chain) < 5:
                chain.append(p.name)
                p = p.cpu_parent
            for k in e.kernels:
                chains[k.name][" < ".join(chain)] += 1
    detail = {k: (ms, c, chains[k].most_common(1)[0][0] if chains[k]
                  else None) for k, (ms, c) in by_name.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:4]
    return (busy, wall, len(device), [(k[:60], ms, c) for k, (ms, c) in top],
            {k: c for k, (ms, c) in by_name.items()}, detail)


def _profiled_launches(names):
    """Kernel launches by the device events' names from :func:`_busy_share`:
    {wrapper's count name: events of its kernel}."""
    kernels = {"fused_epoch": "fused_epoch_kernel",
               "krng_draw": "directions_kernel"}
    return {k: sum(c for name, c in names.items() if v in name)
            for k, v in kernels.items()}


def _graph_vs_eager(label, sub, step_l, gradient, dt, smi):
    """Graph against eager (``config.fused_cuda_graph``) on one workload at
    524,288 spins x 150 steps x 32 measurements: the first call of the
    shape (for the graphed run: one eager epoch, the capture, the
    replays), the median of timed runs, the launches the wrappers counted
    against the kernels the profiler saw, bit-for-bit results."""
    from disimpy_tpu_torch import simulations
    from disimpy_tpu_torch.engine import (config, draw_kernel, fused, krng,
                                          launch_count)

    n = 524288
    out = {}

    def sim(seed):
        return simulations.simulation(
            n, DIFFUSIVITY, gradient, dt, sub, seed=seed, quiet=True,
            final_pos=True, device="cuda")

    try:
        for graphed in (True, False):
            config.fused_cuda_graph = graphed
            # Earlier phases captured this shape: drop their graphs.
            torch.cuda.synchronize()
            fused._GRAPHS.clear()
            t0 = time.perf_counter()
            sim(1)
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            walls = []
            for _ in range(GRAPH_READINGS):
                launch_count.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = sim(2)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            k1 = launch_count.counts["fused_epoch"]
            k7 = launch_count.counts["krng_draw"]
            launch_count.reset()
            busy, wall_ms, events, top, names, _ = _busy_share(
                lambda: sim(2))
            out[graphed] = dict(
                first=first, walls=walls, median=float(np.median(walls)),
                res=res, k1=k1, k7=k7, counted=dict(launch_count.counts),
                profiled=_profiled_launches(names), busy_ms=busy,
                profiled_ms=wall_ms, events=events, top=top)
        same_sim = all(np.array_equal(a, b)
                       for a, b in zip(out[True]["res"], out[False]["res"]))
        # The window itself, untracked and tracked: positions, phases,
        # iter_exc (and the trackers) bit for bit.
        args = _window_inputs(sub, step_l, gradient, dt, n, 2)
        same_window = {}
        for track in (False, True):
            runs = {}
            for graphed in (True, False):
                config.fused_cuda_graph = graphed
                runs[graphed] = _flat(_window(*args, 2, track))
            same_window[track] = all(torch.equal(a, b) for a, b in
                                     zip(runs[True], runs[False]))
        # K7's walk against the plain draws' walk (eager: a graph replay
        # would launch K7 again).
        config.fused_cuda_graph = False
        k7_pos = runs[False][0]
        kernel = draw_kernel.unit_directions_epoch
        draw_kernel.unit_directions_epoch = krng.unit_directions_epoch
        try:
            plain_pos = _flat(_window(*args, 2, True))[0]
        finally:
            draw_kernel.unit_directions_epoch = kernel
        apart = float(((k7_pos - plain_pos).abs().amax(dim=0) > 1e-4)
                      .double().mean())
    finally:
        config.fused_cuda_graph = True
    g, e = out[True], out[False]
    say(f"graph vs eager, {label}: {n} spins x {gradient.shape[1]} steps x "
        f"{gradient.shape[0]} meas; signals and final positions "
        f"{'equal' if same_sim else 'DIFFERENT'} bit for bit; the window's "
        "positions, phases and iter_exc "
        f"{'equal' if same_window[False] else 'DIFFERENT'} untracked, with "
        f"crossings and intra steps "
        f"{'equal' if same_window[True] else 'DIFFERENT'} tracked; walks "
        f"with K7's draws against the plain draws: {apart:.3g} of the spins "
        "more than 1e-4 step lengths apart (limit 0.005); first call of the "
        f"shape {g['first']:.4f} s graphed (eager epoch, capture, replays), "
        f"{e['first']:.4f} s eager; median of {GRAPH_READINGS} runs "
        f"{g['median']:.4f} s graphed "
        f"({min(g['walls']):.4f}-{max(g['walls']):.4f}), {e['median']:.4f} s "
        f"eager ({min(e['walls']):.4f}-{max(e['walls']):.4f}) ({smi}); "
        f"fused_epoch / krng_draw launches per run {g['k1']} / {g['k7']} "
        f"graphed, {e['k1']} / {e['k7']} eager; in the profiled run counted "
        f"{g['counted']['fused_epoch']} / {g['counted']['krng_draw']}, "
        f"kernels seen by the profiler {g['profiled']['fused_epoch']} / "
        f"{g['profiled']['krng_draw']} graphed, counted "
        f"{e['counted']['fused_epoch']} / {e['counted']['krng_draw']}, seen "
        f"{e['profiled']['fused_epoch']} / {e['profiled']['krng_draw']} "
        f"eager; one profiled run: device "
        f"busy {g['busy_ms']:.1f} of {g['profiled_ms']:.1f} ms "
        f"({g['busy_ms'] / g['profiled_ms']:.3f}) with {g['events']} device "
        f"events graphed, {e['busy_ms']:.1f} of {e['profiled_ms']:.1f} ms "
        f"({e['busy_ms'] / e['profiled_ms']:.3f}) with {e['events']} eager; "
        "most device time, graphed: " + "; ".join(
            f"{name} {ms:.1f} ms x {count}" for name, ms, count in g["top"]))
    if not (same_sim and all(same_window.values())):
        raise AssertionError(f"graph vs eager, {label}: runs differ")
    if apart > 0.005:
        raise AssertionError(f"graph vs eager, {label}: K7's walk is "
                             "further from the plain draws' than allowed")
    if not (g["k1"] == e["k1"] == g["k7"] == e["k7"] > 0):
        raise AssertionError(f"graph vs eager, {label}: launch counts differ")
    for run in (g, e):
        counted = {k: run["counted"][k] for k in run["profiled"]}
        if (counted != run["profiled"]
                or run["profiled"]["fused_epoch"] != g["k1"]):
            raise AssertionError(
                f"graph vs eager, {label}: the wrappers counted {counted} "
                f"launches, the profiler saw {run['profiled']} kernels")
    return dict(graph=g["median"], eager=e["median"], first=(g["first"],
                e["first"]), walls=(g["walls"], e["walls"]),
                launches=g["k1"], apart=apart,
                busy=(g["busy_ms"] / g["profiled_ms"],
                      e["busy_ms"] / e["profiled_ms"]))


def draws_and_graph(bench, neuron, smi):
    """Phase 18: the draw kernel K7 against its plain version
    (:func:`_draw_check`), then graph against eager on the bundle and on
    the neuron (:func:`_graph_vs_eager`)."""
    draws = _draw_check()
    runs = {
        label: _graph_vs_eager(label, sub, bench["step_l"],
                               bench["gradient"], bench["dt"], smi)
        for label, sub in (("bundle", bench["substrate"]),
                           ("neuron", neuron["substrate"]))
    }
    return dict(draws=draws, runs=runs)


# K8's floating-point operations per collision check (the quadric's root
# ~20, the normal ~20, a hit's reflection ~40) and per direction draw (cos
# and sin ~20 each, ~10 more); each threefry block it draws (one for the
# direction, one per hit) is K7_INT_OPS integer instructions.
K8_FLOPS_PER_CHECK = 80
K8_DRAW_FLOPS = 50
# The mesh step against the plain loop on the gather query: the two
# queries round the Moller-Trumbore test differently (K2 contracts it into
# FMAs), so walks may end this many step lengths apart (7.63e-6 float32 and
# 1.42e-14 float64 seen on an H100), and at most MAX_STEP_APART of the
# spins further apart or with other exc or crossings (a grazing bounce that
# rounds the other way).
GATHER_APART = {torch.float32: 1e-5, torch.float64: 1e-12}
MAX_STEP_APART = 0.005
# Most start classifications in which the card and the CPU may differ:
# the float32 ray parity of a grazed facet edge (ROADMAP fault 4).
MAX_CLASSIFY_DIFFER = 1e-5


def _kernel_device_ms(fn, names, reps=5):
    """Device ms per ``fn()`` call summed over the kernels whose names
    contain each of ``names``: torch.profiler over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type.name == "CUDA"]
    return {k: sum(e.self_device_time_total for e in device if k in e.name)
            / 1e3 / reps for k in names}


def _checks_by_k(step_at, max_iter=1000):
    """[#spins with iters >= k for k = 1, 2, ...] of one step, read from
    the kernel's exc flags at max_iter = k (the walk up to check k does
    not depend on max_iter), up to ``max_iter``. Their sum is the step's
    collision checks."""
    counts = []
    for k in range(1, min(64, max_iter) + 1):
        c = int(step_at(k)[1].sum())
        if c == 0:
            break
        counts.append(c)
    return counts


def _later_queries(run):
    """The halo cells of the spins each query of the plain mesh loop
    serves, in call order, while ``run()`` runs it: the first entry is the
    first pass, the others the compacted later passes
    (``mesh_kernel.halo_cells`` of the query's inputs)."""
    from disimpy_tpu_torch.engine import mesh_kernel, stepping

    make = stepping._make_mesh_query
    calls = []

    def recording(spec, dtype, device):
        query = make(spec, dtype, device)

        def recorded(r0, direction, rem):
            cell, _ = mesh_kernel.halo_cells(spec, r0, direction, rem)
            calls.append(cell)
            return query(r0, direction, rem)
        return recorded

    stepping._make_mesh_query = recording
    try:
        run()
    finally:
        stepping._make_mesh_query = make
    return calls


# K9's and K8's times per launch before their redesign (the kernels of
# commit 9f0b714, as PERF.md records them; NVIDIA H100 80GB HBM3, 700 W),
# printed beside this run's.
K9_BEFORE_MS = {"bundle float32 perm 0.0": 0.1603,
                "bundle float32 perm 0.5": 0.1335,
                "bundle float64 perm 0.0": 0.2746,
                "bundle float64 perm 0.5": 0.2246}
K8_BEFORE_MS = {("sphere", "float32"): "0.0171-0.0179",
                ("cylinder", "float32"): "0.0150-0.0172",
                ("ellipsoid", "float32"): "0.0230-0.0253",
                ("sphere", "float64"): "0.0258-0.0285",
                ("cylinder", "float64"): "0.0233-0.0260",
                ("ellipsoid", "float64"): "0.0334-0.0340"}
# The kernels of K9 (csrc/mesh_hit.cu): the worklist's sort by cell, the
# staged second check, the warp-per-spin remainder, the tail.
K9_KERNELS = ("relist_cells", "relist_scan", "relist_scatter", "later_pass",
              "bounce_pass", "finish_pass")


def _step_check(kind, label, spec, pos, eps, max_iter=1000,
                min_exc=0):
    """One classic step, the step kernels against the plain version on the
    same positions and draws. K8: positions, exc and crossings per spin bit
    for bit. The mesh step: bit for bit with the plain loop on K2's query,
    and against the plain loop on the gather query at most MAX_STEP_APART
    of the spins more than GATHER_APART[dtype] step lengths apart (or with
    other exc or crossings); the same for the first pass alone (max_iter 1:
    K2's resolve epilogue and the tail). At least ``min_exc`` spins must
    end over the budget. Returns the record (times, bounds, counts)."""
    from disimpy_tpu_torch.engine import (analytic_kernel, config,
                                          draw_kernel, mesh_kernel, stepping)

    n = pos.shape[1]
    dtype = pos.dtype
    name = str(dtype)[6:]
    size = pos.element_size()
    ids = torch.arange(n, dtype=torch.int32, device="cuda")
    seed, t = 4321, 17
    scal = draw_kernel.device_scalars((seed, t), "cuda")
    if kind == "mesh":
        def kernel(max_iter=max_iter):
            return mesh_kernel.mesh_step(spec, pos, eps, max_iter, scal[0],
                                         scal[1], ids)
    else:
        def kernel(max_iter=max_iter):
            return analytic_kernel.analytic_step(
                kind, pos, spec, eps, max_iter, scal[0], scal[1], ids)

    def plain(max_iter=max_iter, query=None):
        """The plain version; a mesh on K2's query (the one
        config.mesh_query_backend picks on the card), or on ``query``."""
        backend = config.mesh_query_backend
        try:
            if query is not None:
                config.mesh_query_backend = lambda *a: query
            return stepping.plain_step(kind, pos, spec, eps, max_iter, seed,
                                       t, ids)
        finally:
            config.mesh_query_backend = backend

    def compare(a, b, limit=0.0):
        same = (a[0] == b[0]).all(dim=0) & (a[1] == b[1]) & (a[2] == b[2])
        apart = (((a[0] - b[0]).abs().amax(dim=0) > limit) | (a[1] != b[1])
                 | (a[2] != b[2]))
        err = float((a[0] - b[0]).abs().max())
        return int((~same).sum()), int(apart.sum()), err

    out = kernel()
    exc = int(out[1].sum())
    if kind == "mesh":
        limit = GATHER_APART[dtype]
        differ, apart, err = compare(out, plain(query="gather"), limit)
        differ_k2, _, _ = compare(out, plain())
        first = kernel(1)
        first_differ, first_apart, first_err = compare(
            first, plain(1, "gather"), limit)
        first_differ_k2, _, _ = compare(first, plain(1))
        ok = (differ_k2 == 0 and first_differ_k2 == 0
              and max(apart, first_apart) <= MAX_STEP_APART * n)
        result = (f"against the plain loop on K2's query {differ_k2} spins "
                  f"not bit for bit equal (first pass {first_differ_k2}); "
                  f"on the gather query {differ} not bit for bit equal, "
                  f"{apart} more than {limit:g} step lengths apart (limit "
                  f"{MAX_STEP_APART * n:g}), max |diff| {err:.3g} (first "
                  f"pass: {first_differ}, {first_apart}, {first_err:.3g})")
        plain_ms, _ = _cuda_ms(lambda: plain(query="gather"), 3)
        first_plain_ms, _ = _cuda_ms(lambda: plain(1, "gather"), 3)
    else:
        differ, apart, err = compare(out, plain())
        ok = differ == 0
        result = (f"{differ} spins not bit for bit equal, max |diff| "
                  f"{err:.3g}")
        plain_ms, _ = _cuda_ms(plain, 3)
    ok = ok and exc >= min_exc
    by_k = _checks_by_k(kernel, max_iter)
    checks = sum(by_k)
    hits = max(checks - n, 0)
    ms = _graph_ms(kernel, 20)
    record = dict(kind=kind, label=label, n=n, differ=differ, apart=apart,
                  max_abs_err=err, ms=ms, plain_ms=plain_ms, checks=checks,
                  crossings=int(out[2].sum()), exc=exc, by_k=by_k)
    if kind == "mesh":
        r0 = pos.T.contiguous()
        cell, _ = mesh_kernel.halo_cells(spec, r0, r0, torch.zeros(
            n, dtype=dtype, device="cuda"))
        per_row = float(spec.cell_counts[cell].double().mean())
        listed = by_k[1] if len(by_k) > 1 else 0
        rest = by_k[2] if len(by_k) > 2 else 0
        times = _kernel_device_ms(lambda: kernel(), (
            "hit_pass", "cell_pass", "scan_pass", "scatter_pass",
            "directions_kernel") + K9_KERNELS)
        # K2 on the main path (the first pass, its resolve epilogue
        # included): each spin's r0, direction, rem and id read once, its
        # resolved state, iters and crossings written once, the listed
        # spins' worklist entries; each touched row's records read once and
        # one test per record of each spin's row.
        touched = torch.unique(cell)
        k2_bytes = (int(spec.cell_counts[touched].sum()) * 12 * size
                    + spec.cell_counts.numel() * 4 + n * (14 * size + 12)
                    + listed * 4)
        k2_flops = int(spec.cell_counts[cell].sum()) * (
            mesh_kernel.FLOPS_PER_RECORD)
        k2_bound_ms, k2_bound_by = bound(k2_bytes, k2_flops, name)
        # K9 (every check after the first, and the tail), counted from the
        # queries the plain loop makes on these inputs: one test per record
        # of the row of each later check; each row a later check reads,
        # read once; the state of each spin checked again (r0, direction,
        # rem, iters, crossings, id) read once and written once per pass
        # it is listed for; the tail's reads (state) and writes (positions,
        # exc) of every spin.
        later = _later_queries(lambda: plain())[1:]
        tests = sum(int(spec.cell_counts[c].sum()) for c in later)
        rows = (torch.unique(torch.cat(later)) if later else
                torch.zeros(0, dtype=torch.long, device="cuda"))
        n_bytes = (int(spec.cell_counts[rows].sum()) * 12 * size
                   + (listed + rest) * (14 * size + 20)
                   + n * (10 * size + 5))
        flops = tests * mesh_kernel.FLOPS_PER_RECORD
        k9_ms = sum(times[k] for k in K9_KERNELS)
        record.update(
            k9_ms=k9_ms, later_ms=sum(times[k] for k in K9_KERNELS[:4]),
            rest_ms=times["bounce_pass"], tail_ms=times["finish_pass"],
            k2_ms=sum(times[k] for k in ("hit_pass", "cell_pass",
                                         "scan_pass", "scatter_pass")),
            k7_ms=times["directions_kernel"], listed=listed, rest=rest,
            later_tests=tests, later_rows=int(rows.numel()),
            records_per_row=per_row, first_err=first_err,
            first_plain_ms=first_plain_ms, k2_bound_ms=k2_bound_ms,
            k2_bound_by=k2_bound_by)
    else:
        per_spin = getattr(spec, "radius", torch.zeros(())).numel() == n
        n_bytes = n * (6 * size + 9 + (size if per_spin else 0))
        flops = checks * K8_FLOPS_PER_CHECK + n * K8_DRAW_FLOPS
    bound_ms, bound_by = bound(n_bytes, flops, name)
    if kind != "mesh":
        int_ms, _ = bound(0, (n + hits) * K7_INT_OPS, "int32")
        if int_ms > bound_ms:
            bound_ms, bound_by = int_ms, "operations"
    record.update(bound_ms=bound_ms, bound_by=bound_by)
    if kind == "mesh":
        detail = (
            f" = K7 {record['k7_ms']:.4f} + K2 {record['k2_ms']:.4f} + K9 "
            f"{record['k9_ms']:.4f} ms (K9 before its redesign: "
            f"{K9_BEFORE_MS.get(label, 'not measured')}); K9 = sort and "
            f"staged second check {record['later_ms']:.4f} "
            f"+ remainder {record['rest_ms']:.4f} + tail "
            f"{record['tail_ms']:.4f} ms; {listed} spins listed after the "
            f"first pass, {rest} for the remainder, checks by k {by_k}, "
            f"{exc} over the budget of {max_iter}; {per_row:.1f} records per "
            f"row; the later checks test {tests} records on "
            f"{record['later_rows']} rows; K2 bound {k2_bound_ms:.4f} ms "
            f"({k2_bound_by}), plain first pass {first_plain_ms:.3f} ms; K9")
    else:
        before = (K8_BEFORE_MS[kind, name] + " ms" if n == 524288
                  else "not measured at this shape")
        detail = f" (before the redesign: {before}); {exc} over the budget"
    say(f"step kernels vs plain, {label}: {n} spins, {checks / n:.3f} "
        f"collision checks per spin, {record['crossings']} crossings; "
        f"{result}; step {ms:.4f} ms (plain {plain_ms:.3f} ms)" + detail
        + f" bound {bound_ms:.4f} ms ({bound_by})")
    if not ok:
        raise AssertionError(f"step kernels ({label}) disagree with the "
                             "plain version" + (
                                 "" if exc >= min_exc else
                                 f", or {exc} spins over the budget is "
                                 f"fewer than {min_exc}"))
    return record


def _analytic_cases(n):
    """(kind, label, spec, positions, epsilon) for K8's checks: each
    substrate x float32 / float64 x perm 0 / 0.5 x one radius / a radius
    per spin, the spins uniform inside a compartment 3 step lengths
    across."""
    from disimpy_tpu_torch.engine import specs

    g = torch.Generator(device="cuda").manual_seed(11)
    cases = []
    for dtype in (torch.float32, torch.float64):
        name = str(dtype)[6:]
        ball = torch.randn((3, n), generator=g, device="cuda", dtype=dtype)
        ball = ball / ball.norm(dim=0) * torch.rand(
            n, generator=g, device="cuda", dtype=dtype) ** (1 / 3)
        eps = 64 * float(torch.finfo(dtype).eps) * 3.0
        for kind in ("sphere", "cylinder", "ellipsoid"):
            for perm in (0.0, 0.5):
                p = torch.tensor(perm, dtype=dtype, device="cuda")
                for per_spin in ((False, True) if kind != "ellipsoid"
                                 else (False,)):
                    r = torch.full((n,) if per_spin else (), 3.0,
                                   dtype=dtype, device="cuda")
                    if per_spin:
                        r = r * (0.8 + 0.4 * torch.rand(
                            n, generator=g, device="cuda", dtype=dtype))
                    if kind == "sphere":
                        spec, pos = specs.SphereSpec(r, p), ball * r
                    elif kind == "cylinder":
                        spec = specs.CylinderSpec(r, p)
                        pos = ball * torch.stack([
                            torch.full_like(ball[0], 5.0), r.expand(n),
                            r.expand(n)])
                    else:
                        ax = torch.tensor([3.0, 2.5, 2.0], dtype=dtype,
                                          device="cuda")
                        spec = specs.EllipsoidSpec(ax, p)
                        pos = ball * ax[:, None]
                    cases.append((kind, f"{kind} {name} perm {perm} "
                                  f"{'per-spin' if per_spin else 'one'} "
                                  "radius", spec, pos.contiguous(), eps))
    return cases


def _misst_cases():
    """(kind, label, spec, positions, epsilon) for K8 at the shape of the
    analytic MISST runs (phase 8): 1e5 spins uniform in a ball inside a
    sphere and a cylinder of radius 5 um, float32, perm 0, at the step
    length of the 30 ms protocol, with the epsilon ``simulation()`` takes
    there."""
    from disimpy_tpu_torch import simulations
    from disimpy_tpu_torch.engine import specs

    n = 100000
    _, dt = _misst_gradient(30, 1000)
    scale = 1.0 / float(np.sqrt(6 * DIFFUSIVITY * dt))
    r = 5e-6 * scale
    g = torch.Generator(device="cuda").manual_seed(13)
    ball = torch.randn((3, n), generator=g, device="cuda")
    ball = ball / ball.norm(dim=0) * torch.rand(
        n, generator=g, device="cuda") ** (1 / 3)
    radius = torch.tensor(r, device="cuda")
    perm = torch.tensor(0.0, device="cuda")
    cases = []
    for kind, spec_cls in (("sphere", specs.SphereSpec),
                           ("cylinder", specs.CylinderSpec)):
        eps = simulations._effective_epsilon(1e-13, scale, r, 1000,
                                             torch.float32, kind == "sphere")
        cases.append((kind, f"{kind} float32 MISST shape ({n} spins, r = "
                      f"{r:.3f} steps)", spec_cls(radius, perm),
                      (ball * r).contiguous(), eps))
    return cases


def _classify_check(label, sub, n, step_l=None):
    """Start classification on the card against the CPU path on n points
    uniform in the substrate's voxel: at most MAX_CLASSIFY_DIFFER of them
    may differ. Returns (card s, cpu s, differing)."""
    from disimpy_tpu_torch import simulations

    points = np.random.RandomState(17).random_sample((n, 3)) * np.asarray(
        sub.voxel_size)
    walls = {}
    inside = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        inside[device] = simulations._make_intra_classifier(sub, device)(
            points)
        walls[device] = time.perf_counter() - t0
    differ = int((inside["cuda"] != inside["cpu"]).sum())
    say(f"start classifier, {label}: {n} points uniform in the voxel, "
        f"{int(inside['cuda'].sum())} inside; card {walls['cuda']:.3f} s, "
        f"CPU {walls['cpu']:.3f} s; {differ} classified differently (limit "
        f"{MAX_CLASSIFY_DIFFER * n:g})")
    if differ > MAX_CLASSIFY_DIFFER * n:
        raise AssertionError(f"start classifier ({label}): the card and the "
                             "CPU disagree")
    return walls["cuda"], walls["cpu"], differ


CLASSIC_KERNELS = {"analytic_step": "analytic_step_kernel",
                   "mesh_hit": "hit_pass", "mesh_later": "later_pass",
                   "mesh_bounce": "bounce_pass",
                   "krng_draw": "directions_kernel"}


def _device_ms(detail, part):
    """(ms, count) summed over the profiled device events whose names
    contain ``part`` (``_busy_share``'s last record)."""
    hits = [(ms, c) for name, (ms, c, _) in detail.items() if part in name]
    return sum(ms for ms, _ in hits), sum(c for _, c in hits)


def _classic_graph_vs_eager(label, sim, profiled=False):
    """A classic run through ``simulation()`` graphed
    (``config.classic_cuda_graph``) against eager: the first call of the
    shape, the median of GRAPH_READINGS timed runs with the launches per
    run, the results bit for bit, and (``profiled``) one torch.profiler run
    each: busy share and the kernels it saw against the launches
    counted."""
    from disimpy_tpu_torch.engine import config, core, launch_count

    out = {}
    try:
        for graphed in (True, False):
            config.classic_cuda_graph = graphed
            torch.cuda.synchronize()
            core._GRAPHS.clear()
            t0 = time.perf_counter()
            sim(1)
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            walls = []
            for _ in range(GRAPH_READINGS):
                launch_count.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = sim(2)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            run = dict(first=first, walls=walls, median=float(np.median(
                walls)), res=res, counts=dict(launch_count.counts))
            if profiled:
                launch_count.reset()
                busy, wall_ms, events, top, names, detail = _busy_share(
                    lambda: sim(2), origins=not graphed)
                run.update(busy=busy / wall_ms, events=events, top=top,
                           seen={k: sum(c for nm, c in names.items()
                                        if v in nm)
                                 for k, v in CLASSIC_KERNELS.items()},
                           counted=dict(launch_count.counts),
                           busy_ms=busy, wall_ms=wall_ms, detail=detail)
            out[graphed] = run
    finally:
        config.classic_cuda_graph = True
    g, e = out[True], out[False]
    res = [r if isinstance(r, tuple) else (r,) for r in (g["res"], e["res"])]
    same = all(np.array_equal(a, b) for a, b in zip(*res))
    launches = {k: v for k, v in g["counts"].items() if v}
    say(f"classic graph vs eager, {label}: results "
        f"{'equal' if same else 'DIFFERENT'} bit for bit; first call "
        f"{g['first']:.4f} s graphed (eager step, capture, replays), "
        f"{e['first']:.4f} s eager; median of {GRAPH_READINGS} runs "
        f"{g['median']:.4f} s graphed ({min(g['walls']):.4f}-"
        f"{max(g['walls']):.4f}), {e['median']:.4f} s eager "
        f"({min(e['walls']):.4f}-{max(e['walls']):.4f}); launches per run "
        f"{launches}" + ("".join(
            f"; profiled {'graphed' if k else 'eager'}: busy {r['busy']:.3f}"
            f" of the wall, {r['events']} device events, kernels seen "
            f"{r['seen']} against counted "
            f"{ {n: r['counted'][n] for n in r['seen']} }; most device time "
            + ", ".join(f"{nm} {ms:.1f} ms x {c}" for nm, ms, c in r["top"])
            for k, r in ((True, g), (False, e))) if profiled else ""))
    if not same:
        raise AssertionError(f"classic graph vs eager ({label}): runs differ")
    if g["counts"] != e["counts"]:
        raise AssertionError(f"classic graph vs eager ({label}): launch "
                             "counts differ")
    profile = {}
    if profiled:
        for r in (g, e):
            if r["seen"] != {k: r["counted"][k] for k in r["seen"]}:
                raise AssertionError(
                    f"classic graph vs eager ({label}): counted "
                    f"{r['counted']}, the profiler saw {r['seen']}")
        # Per kernel, from the graphed run: the step kernels' and the
        # phase product's device time per launch; from the eager run, the
        # operators that launched the kernels with the most device time.
        parts = {"K8": "analytic_step_kernel", "K2": "hit_pass",
                 "K9 staged": "later_pass", "K9 remainder": "bounce_pass",
                 "phase product": "gemm"}
        for key, part in parts.items():
            ms, c = _device_ms(g["detail"], part)
            if c:
                profile[key] = (ms, c)
        top = sorted(e["detail"].items(), key=lambda kv: -kv[1][0])[:6]
        say(f"profile, {label}: graphed run busy {g['busy_ms']:.2f} of "
            f"{g['wall_ms']:.2f} ms; per launch "
            + ", ".join(f"{k} {ms / c:.4f} ms x {c}"
                        for k, (ms, c) in profile.items())
            + "; eager run's kernels by device time: "
            + "; ".join(f"{nm[:150]} {ms:.2f} ms x {c} (from {origin})"
                        for nm, (ms, c, origin) in top))
    return dict(graph=g["median"], eager=e["median"], walls=(g["walls"],
                e["walls"]), first=(g["first"], e["first"]),
                launches=launches, busy=(g.get("busy"), e.get("busy")),
                profile=profile)


def _window_graph_vs_eager(label, run):
    """One classic window graphed against eager, every output bit for
    bit."""
    from disimpy_tpu_torch.engine import config

    outs = {}
    try:
        for graphed in (True, False):
            config.classic_cuda_graph = graphed
            outs[graphed] = _flat(run())
    finally:
        config.classic_cuda_graph = True
    same = all(torch.equal(a, b) for a, b in zip(outs[True], outs[False]))
    say(f"classic window graph vs eager, {label}: "
        f"{'equal' if same else 'DIFFERENT'} bit for bit "
        f"({len(outs[True])} outputs)")
    if not same:
        raise AssertionError(f"classic window ({label}): graph and eager "
                             "differ")


def step_kernel_checks(sub, step_l):
    """Phase 19's step checks (:func:`_step_check`): K8 on every analytic
    case at 524,288 spins and at the MISST shape; the mesh step on the
    bundle's halo pack (``sub`` at step ``step_l``) in both types and
    perms, at a step 10 times longer, and at a budget of 3 checks.
    Returns {"analytic": [records], "mesh": [records]}."""
    from disimpy_tpu_torch import simulations
    from disimpy_tpu_torch.engine import mesh_accel

    n = 524288
    records = {"analytic": [], "mesh": []}
    for case in _analytic_cases(n) + _misst_cases():
        records["analytic"].append(_step_check(*case))
    g = torch.Generator(device="cuda").manual_seed(12)
    # The bundle's halo pack at the bench step, in both types and perms;
    # then float32 at a step 10 times longer (the remainder's heavy case:
    # most spins bounce more than twice) and at a budget of 3 checks (exc
    # set).
    for dtype, mult, max_iter in ((torch.float32, 1, 1000),
                                  (torch.float64, 1, 1000),
                                  (torch.float32, 10, 1000),
                                  (torch.float32, 1, 3)):
        scale = 1.0 / (mult * step_l)
        if mult == 1:
            spec = simulations._classic_mesh_spec(sub, scale, dtype,
                                                  torch.device("cuda"))
        else:
            spec = mesh_accel.pack_mesh(sub, scale, dtype, device="cuda")
        if tuple(spec.spans) != (1, 1, 1):
            raise AssertionError(f"the bundle at {mult} bench steps packs "
                                 "the per-cell layout")
        pos = (torch.rand((3, n), generator=g, device="cuda", dtype=dtype)
               * spec.voxel_size[:, None])
        eps = simulations._effective_epsilon(
            1e-13, scale, float(np.max(sub.voxel_size)) * scale, 150, dtype,
            False)
        name = (f"bundle {str(dtype)[6:]}" + (f", {mult} x the bench step"
                                              if mult != 1 else "")
                + (f", max_iter {max_iter}" if max_iter != 1000 else ""))
        for perm in (0.0, 0.5):
            spec_p = dataclasses.replace(spec, perm_prob=torch.tensor(
                perm, dtype=dtype, device="cuda"))
            records["mesh"].append(_step_check(
                "mesh", f"{name} perm {perm}", spec_p, pos, eps, max_iter,
                min_exc=1 if max_iter < 1000 else 0))
    return records


def classic_on_card(bench, neuron, smi):
    """Phase 19: the classic engine on the card. The step kernels against
    their plain versions at 524,288 spins (K8 on every analytic case; K7 +
    K2 + K9 on the bundle's halo pack); graphed windows and runs against
    eager ones bit for bit (tracked, sweep, trajectory); medians of five
    classic bundle runs (float32, float64) and of the four analytic MISST
    runs with their launches, one profiled bundle run; the start
    classifier on the card against the CPU's on the bundle and the
    neuron."""
    from disimpy_tpu_torch import simulations, substrates, sweeps
    from disimpy_tpu_torch.engine import config, core, launch_count

    n = 524288
    records = step_kernel_checks(bench["substrate"], bench["step_l"])
    sub, step_l = bench["substrate"], bench["step_l"]
    scale = 1.0 / step_l
    g = torch.Generator(device="cuda").manual_seed(14)

    # Windows graphed against eager: tracked (the bundle, perm 0.5), a
    # two-block sweep, and a trajectory window.
    spec = simulations._classic_mesh_spec(sub, scale, torch.float32,
                                          torch.device("cuda"))
    spec = dataclasses.replace(spec, perm_prob=torch.tensor(0.5,
                                                            device="cuda"))
    pos = torch.rand((3, n), generator=g, device="cuda") * spec.voxel_size[
        :, None]
    g_eff = torch.randn((20, 4, 3), generator=g, device="cuda")
    zeros = torch.zeros(n, dtype=torch.int32, device="cuda")
    parity = torch.rand(n, generator=g, device="cuda") < 0.5
    eps = 64 * float(torch.finfo(torch.float32).eps) * 20.0

    def window(**kw):
        return core.run_window(
            "mesh", spec, pos, torch.zeros((4, n), device="cuda"),
            torch.zeros(n, dtype=torch.bool, device="cuda"), g_eff,
            range(5, 25), 3, eps, 1000, **kw)

    _window_graph_vs_eager("bundle mesh, tracked, 20 steps", lambda: window(
        track="exchange", compartments=(zeros, parity, zeros)))
    _window_graph_vs_eager("bundle mesh, trajectory, 20 steps",
                           lambda: window(collect_positions=True))
    gradient, dt = _misst_gradient(30, 100)
    _window_graph_vs_eager("sphere sweep (2, 4, 6, 8 um), 1e4 spins x 100 "
                           "steps", lambda: (torch.from_numpy(
                               sweeps.sweep_sphere_radii(
                                   10000, DIFFUSIVITY, gradient, dt,
                                   np.array([2, 4, 6, 8]) * 1e-6,
                                   device="cuda")),))

    # Whole runs: the classic bundle in float32 (profiled) and float64.
    runs = {}
    try:
        config.use_fused = False
        for dtype in ("float32", "float64"):
            runs["bundle", dtype] = _classic_graph_vs_eager(
                f"classic bundle {dtype}, {n} x 150 x 32 ({smi})",
                lambda seed, dtype=dtype: simulations.simulation(
                    n, DIFFUSIVITY, bench["gradient"], bench["dt"], sub,
                    seed=seed, quiet=True, final_pos=True, dtype=dtype,
                    device="cuda"),
                profiled=dtype == "float32")
    finally:
        config.use_fused = None
    for delta in (30, 1):
        gradient, dt = _misst_gradient(delta, 1000)
        for kind in ("cylinder", "sphere"):
            substrate = (substrates.cylinder(radius=5e-6,
                                             orientation=np.array([0, 0, 1.0]))
                         if kind == "cylinder" else substrates.sphere(5e-6))
            runs[kind, delta] = _classic_graph_vs_eager(
                f"{kind} MISST {delta} ms, 1e5 x 1000 x 100 b ({smi})",
                lambda seed, substrate=substrate: simulations.simulation(
                    100000, DIFFUSIVITY, gradient, dt, substrate, seed=seed,
                    quiet=True, final_pos=True, device="cuda"),
                profiled=(kind, delta) == ("sphere", 30))
    classify = {
        "bundle": _classify_check("bench bundle", sub, n),
        "neuron": _classify_check("neuron", neuron["substrate"], n),
    }
    k8 = [r for r in records["analytic"]
          if r["label"] == "sphere float32 perm 0.0 one radius"][0]
    k9 = [r for r in records["mesh"]
          if r["label"] == "bundle float32 perm 0.0"][0]
    k8_misst = [r for r in records["analytic"]
                if r["label"].startswith("sphere float32 MISST shape")][0]
    ms, c = runs["sphere", 30]["profile"]["K8"]
    return dict(records=records, runs=runs, classify=classify, k8=k8, k9=k9,
                k8_misst=k8_misst, k8_run_ms=ms / c)


def main():
    phases = (
        "card", "threefry", "bench setup", "fused kernel vs plain", "free",
        "mesh MISST", "fused bench", "mesh_hit vs plain", "analytic oracles",
        "classic mesh", "classic bench", "exchange oracles", "tracked window",
        "tracked bench", "split and sweeps", "parity matrix",
        "neuron workload", "J and width sweep", "draws and graph",
        "classic on the card",
    )
    walls = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        say(f"[phase {name}: {walls[name]:.1f} s]")
        return out

    smi = timed(phases[0], card)
    parity = _parity_torch().Parity("cuda")
    timed(phases[1], threefry_check)
    bench = timed(phases[2], bench_setup)
    packer = None
    try:
        kp = timed(phases[3], kernel_vs_plain, bench)
        timed(phases[4], free_oracle, parity)
        timed(phases[5], misst_oracle, parity)
        runs = timed(phases[6], bench_run, bench, smi)
        mh = timed(phases[7], mesh_hit_vs_plain, bench)
        timed(phases[8], analytic_oracles, parity)
        timed(phases[9], classic_mesh)
        classic = timed(phases[10], classic_bench, bench, smi, runs)
        timed(phases[11], exchange_oracles, parity)
        timed(phases[12], tracked_window)
        timed(phases[13], tracked_bench, bench, smi, runs)
        # Phase 17's bundle packs pass beside phases 14-16, after the
        # bench runs whose host time phases 6, 10 and 13 report.
        packer = _Packer([p for p in sweep_points(
            bench["spec"], bench["substrate"], 1.0 / bench["step_l"])
            if p != (4, None)])
        timed(phases[14], split_and_sweeps)
        timed(phases[15], parity_matrix, parity)
        neuron = timed(phases[16], neuron_workload, bench, smi)
        timed(phases[17], knob_sweep, bench, neuron, smi, packer)
        dg = timed(phases[18], draws_and_graph, bench, neuron, smi)
        cc = timed(phases[19], classic_on_card, bench, neuron, smi)
    finally:
        if packer is not None:
            packer.stop()
    say(f"phases took {sum(walls.values()):.1f} s in all")
    k1 = kp[524288, 0.0]
    k7 = dg["draws"]["float32", 4]
    print(json.dumps({"kernels": [
        {
            "name": "fused_epoch",
            "route": "cuda",
            "source": "disimpy_tpu_torch/csrc/fused_epoch.cu",
            "replaces": "disimpy_tpu/engine/pallas_fused.py:277",
            "launches": runs["timed"]["launches"],
            "max_abs_err": max(r["max_abs_err"] for r in kp.values()),
            "ms": k1["ms"],
            "count_ms": k1["count_ms"],
            "plain_ms": k1["plain_ms"],
            "bound_ms": k1["bound_ms"],
            "bound_by": k1["bound_by"],
            "library_ms": None,
        },
        {
            "name": "mesh_hit",
            "route": "cuda",
            "source": "disimpy_tpu_torch/csrc/mesh_hit.cu",
            "replaces": "disimpy_tpu/engine/pallas_mesh.py:119",
            "launches": classic["timed"]["launches"],
            "max_abs_err": max(r["first_err"] for r in cc["records"]["mesh"]),
            "ms": cc["k9"]["k2_ms"],
            "plain_ms": cc["k9"]["first_plain_ms"],
            "bound_ms": cc["k9"]["k2_bound_ms"],
            "bound_by": cc["k9"]["k2_bound_by"],
            "library_ms": None,
            "query_ms": mh["ms"],
            "query_plain_ms": mh["plain_ms"],
            "query_bound_ms": mh["bound_ms"],
            "query_max_abs_err": mh["max_abs_err"],
        },
        {
            "name": "krng_draw",
            "route": "cuda",
            "source": "disimpy_tpu_torch/csrc/krng_draw.cu",
            "replaces": "disimpy_tpu/engine/krng.py:77 (XLA-fused threefry "
                        "drawn at disimpy_tpu/engine/fused.py:946; no "
                        "pl.pallas_call)",
            "launches": runs["timed"]["draws"],
            "max_abs_err": max(r["max_abs_err"]
                               for r in dg["draws"].values()),
            "ms": k7["ms"],
            "plain_ms": k7["plain_ms"],
            "bound_ms": k7["bound_ms"],
            "bound_by": k7["bound_by"],
            "library_ms": None,
        },
        {
            "name": "analytic_step",
            "route": "cuda",
            "source": "disimpy_tpu_torch/csrc/analytic_step.cu",
            "replaces": "disimpy_tpu/engine/stepping.py:143 (XLA ops of "
                        "_bounce_analytic's lax.while_loop; no "
                        "pl.pallas_call)",
            "launches": cc["runs"]["sphere", 30]["launches"]["analytic_step"],
            "max_abs_err": max(r["max_abs_err"]
                               for r in cc["records"]["analytic"]),
            "ms": cc["k8"]["ms"],
            "plain_ms": cc["k8"]["plain_ms"],
            "bound_ms": cc["k8"]["bound_ms"],
            "bound_by": cc["k8"]["bound_by"],
            "library_ms": None,
            "misst_ms": cc["k8_misst"]["ms"],
            "misst_plain_ms": cc["k8_misst"]["plain_ms"],
            "misst_bound_ms": cc["k8_misst"]["bound_ms"],
            "misst_run_ms": cc["k8_run_ms"],
        },
        {
            "name": "mesh_bounce",
            "route": "cuda",
            "source": "disimpy_tpu_torch/csrc/mesh_hit.cu",
            "replaces": "disimpy_tpu/engine/stepping.py:305 (the later "
                        "passes of pallas_mesh.py:119 under "
                        "lax.while_loop)",
            "launches": cc["runs"]["bundle", "float32"]["launches"][
                "mesh_bounce"],
            "max_abs_err": max(r["max_abs_err"]
                               for r in cc["records"]["mesh"]),
            "ms": cc["k9"]["k9_ms"],
            "staged_ms": cc["k9"]["later_ms"],
            "remainder_ms": cc["k9"]["rest_ms"],
            "staged_launches": cc["runs"]["bundle", "float32"]["launches"][
                "mesh_later"],
            "step_ms": cc["k9"]["ms"],
            "plain_ms": cc["k9"]["plain_ms"],
            "bound_ms": cc["k9"]["bound_ms"],
            "bound_by": cc["k9"]["bound_by"],
            "library_ms": None,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
