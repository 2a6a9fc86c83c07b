"""Full-size accuracy parity of the PyTorch port on one CUDA GPU.

The port's copy of ``scripts/parity_r04.py``: the same 37 checks as
``PARITY_r05.json`` (the same setups, spin counts, steps, seeds, b-values,
thresholds and key names), run through
``disimpy_tpu_torch.simulations.simulation(..., device=...)``:

    python3 scripts/parity_torch.py [--out PARITY_torch.json]
        [--groups free,analytic,mesh,neuron,exchange] [--commit TEXT]

It writes a JSON file with ``PARITY_r05.json``'s keys after every check.
Each check also names the engine that served its run ("fused", "classic",
or "classic (handed over: ...)"), the classic pack's layout where there is
one, the host times of the fused pack, the classic pack and the seeding,
the wall time of the ``simulation()`` call and the kernel launches. The
``_meta`` entry holds the card's name and power limit (nvidia-smi), the
torch, CUDA and nvcc versions, the commit, the elapsed time, ``all_pass``,
and, per (periodic, padding) pair of the mesh matrix, how far the signals
of its three ``n_sv`` runs lie apart (the fused pack does not depend on
``n_sv``, so they should be equal bit for bit).

On one H100 the whole matrix takes about 9 minutes (553 s), most of it
the host packs of the three neuron runs. There is no fallback: with no
GPU the script fails unless ``--device cpu`` is given, which runs the plain
versions (the CPU tests drive the groups that way at a tiny size, where the
values need not meet the thresholds).

Each group of checks is a method of :class:`Parity`, so ``chip_smoke.py``
can run the groups it does not run itself; :func:`matrix` lists the (key,
threshold) pairs without running anything.
"""

import argparse
import contextlib
import json
import pathlib
import pickle
import subprocess
import sys
import time
import warnings

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from disimpy_tpu_torch import gradients, simulations, substrates  # noqa: E402
from disimpy_tpu_torch.engine import launch_count  # noqa: E402

ORACLES = ROOT / "tests" / "oracles"
D = 2e-9
GROUPS = ("free", "analytic", "mesh", "neuron", "exchange")
# The closed-cylinder mesh matrix: {periodic} x {padding} x {n_sv}.
MESH_PERIODIC = (True, False)
MESH_PADDING = (0, 1)  # 0: none, 1: 2 um on every side
MESH_NSV = ((1, 1, 1), (1, 5, 20), (10, 10, 10))
NEURON_DTS = (1e-5, 1e-3, 1e-1)
MISST_THRESHOLD, LEAK_THRESHOLD = 0.015, 1e-3


def mesh_key(periodic, pad, n_sv):
    return (f"mesh_misst_p{int(periodic)}_pad{int(pad)}"
            f"_nsv{'x'.join(map(str, n_sv))}")


def matrix():
    """The (key, threshold) pairs of the 37 checks, in PARITY_r05's order."""
    out = [("free_vs_exp", 0.01)]
    for delta in (30, 1):
        out += [(f"cylinder_misst_{delta}ms", 0.01),
                (f"sphere_misst_{delta}ms", 0.01)]
    for periodic in MESH_PERIODIC:
        for pad in MESH_PADDING:
            for n_sv in MESH_NSV:
                key = mesh_key(periodic, pad, n_sv)
                out += [(key, MISST_THRESHOLD), (key + "_leak", LEAK_THRESHOLD)]
    out += [(f"neuron_leak_dt{dt:g}", 1.0) for dt in NEURON_DTS]
    out += [("fused_exchange_weight_consistency", 1e-4),
            ("fused_exchange_rate_nonzero", 10.0),
            ("perm_sphere_weight_consistency", 1e-4),
            ("perm_sphere_escape", 1.0),
            ("uniform_t2_exact", 1e-5)]
    return out


def misst_protocol(small_delta_ms, bs, n_t=1000):
    """The PGSE protocols of the vendored MISST signals."""
    if small_delta_ms == 30:
        T, n0, lobe = 70e-3, 700, 300
    else:
        T, n0, lobe = 41e-3, 410, 10
    g = np.zeros((1, n0, 3))
    g[0, 1:lobe, 0] = 1
    g[0, -lobe:-1, 0] = -1
    g = np.concatenate([g for _ in bs], axis=0)
    g, dt = gradients.interpolate_gradient(g, T / (n0 - 1), n_t)
    return gradients.set_b(g, dt, bs), dt


@contextlib.contextmanager
def _watch():
    """Record how the ``simulation()`` calls inside the block ran: the
    engine, the classic pack's layout, the host times of the fused pack,
    the classic pack and the seeding, and the kernel launches."""
    info = dict(fused_pack_s=0.0, classic_pack_s=0.0, seed_s=0.0)
    names = ("_fused_spec", "_classic_mesh_spec", "_fill_mesh")
    orig = {k: getattr(simulations, k) for k in names}

    def timed(name, key, note):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = orig[name](*args, **kwargs)
            info[key] += time.perf_counter() - t0
            note(out)
            return out
        return call

    def fused_note(spec):
        info["fused_table"] = spec is not None

    def classic_note(spec):
        info["classic_layout"] = (
            "halo (K2, K9)" if tuple(spec.spans) == (1, 1, 1)
            else "per-cell (K10, K9's remainder)")

    wrapped = {
        "_fused_spec": timed("_fused_spec", "fused_pack_s", fused_note),
        "_classic_mesh_spec": timed("_classic_mesh_spec", "classic_pack_s",
                                    classic_note),
        "_fill_mesh": timed("_fill_mesh", "seed_s", lambda _: None),
    }
    before = dict(launch_count.counts)
    for k in names:
        setattr(simulations, k, wrapped[k])
    try:
        yield info
    finally:
        for k in names:
            setattr(simulations, k, orig[k])
        info["launches"] = {k: launch_count.counts[k] - before[k]
                            for k in launch_count.KERNELS}
        fused = info.pop("fused_table", None)
        classic = "classic_layout" in info
        if fused is None:
            info["engine"] = "classic"
        elif not fused:
            info["engine"] = "classic (handed over: no fused table fits)"
        elif classic:
            info["engine"] = ("classic (handed over: effective epsilon above "
                              "the fused table's budget)")
        else:
            info["engine"] = "fused"


class Parity:
    """Runs groups of checks and records them.

    ``device`` is where ``simulation()`` runs; ``spins`` and ``steps``
    scale every spin count and step count (1.0: the full size of
    PARITY_r05). With ``out`` the results are written there after every
    check.
    """

    def __init__(self, device="cuda", spins=1.0, steps=1.0, out=None,
                 quiet=False):
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise SystemExit("parity_torch: torch finds no CUDA GPU (pass "
                             "--device cpu to run the plain versions)")
        self.device, self.spins, self.steps = device, spins, steps
        self.out, self.quiet = out, quiet
        self.results = {}
        self.meta = {}
        # The mesh group's substrates by check key, with the packs their
        # runs used in their caches.
        self.substrates = {}
        self.t_start = time.time()

    def n(self, count):
        return max(8, int(round(count * self.spins)))

    def t(self, count):
        return max(8, int(round(count * self.steps)))

    def simulate(self, *args, **kwargs):
        """``simulation(*args, device=..., quiet=True, **kwargs)`` and a
        dict of how it ran (:func:`_watch`) with its wall time."""
        if self.device != "cpu":
            torch.cuda.synchronize()
        with _watch() as info:
            t0 = time.perf_counter()
            out = simulations.simulation(*args, quiet=True,
                                         device=self.device, **kwargs)
            if self.device != "cpu":
                torch.cuda.synchronize()
            info["wall_s"] = time.perf_counter() - t0
        return out, info

    def record(self, name, value, threshold, run=None, extra=None):
        ok = bool(value < threshold)
        entry = {"value": float(value), "threshold": threshold, "pass": ok}
        entry.update(extra or {})
        entry.update(run or {})
        self.results[name] = entry
        if not self.quiet:
            how = (f" [{run['engine']}, fused pack {run['fused_pack_s']:.1f} "
                   f"s, seeding {run['seed_s']:.1f} s, wall "
                   f"{run['wall_s']:.1f} s]" if run else "")
            print(f"{name}: {value:.5g} (< {threshold}) "
                  f"{'PASS' if ok else 'FAIL'}{how}", flush=True)
        self.write()

    def free(self):
        bfree = np.linspace(1, 2e9, 100)
        n = self.n(1e5)
        g, dt = gradients.pgse(20e-3, 40e-3, self.t(1000), bfree,
                               np.tile([[1.0, 0, 0]], (100, 1)))
        s, run = self.simulate(n, D, g, dt, substrates.free())
        self.record("free_vs_exp", np.abs(s / n - np.exp(-bfree * D)).max(),
                    0.01, run)

    def analytic(self):
        """The cylinder and the sphere against MISST at small delta 30 and
        1 ms. Returns {(kind, delta): (signals, final positions)}."""
        bs = np.linspace(1, 3e9, 100)
        n = self.n(1e5)
        runs = {}
        for delta in (30, 1):
            g, dt = misst_protocol(delta, bs, self.t(1000))
            for kind in ("cylinder", "sphere"):
                misst = np.loadtxt(
                    ORACLES / f"misst_{kind}_signal_smalldelta_{delta}ms_"
                    "bigdelta_40ms_radius_5um.txt")
                sub = (substrates.cylinder(radius=5e-6,
                                           orientation=np.array([0, 0, 1.0]))
                       if kind == "cylinder" else substrates.sphere(5e-6))
                (s, pos), run = self.simulate(n, D, g, dt, sub,
                                              final_pos=True)
                self.record(f"{kind}_misst_{delta}ms",
                            np.abs(s / n - misst).max(), 0.01, run)
                runs[kind, delta] = (s, pos)
        return runs

    def mesh(self, periodic=MESH_PERIODIC, padding=MESH_PADDING,
             n_svs=MESH_NSV, dtype="float32"):
        """The closed cylinder mesh against MISST over the given periodic,
        padding and n_sv values, each run with its radial leak check
        (``dtype`` "float64" runs the classic engine).
        Returns {key: (signals, final positions)}, and records in the meta
        how far apart each (periodic, padding) pair's n_sv runs lie."""
        with open(ORACLES / "cylinder_mesh_closed.pkl", "rb") as f:
            m = pickle.load(f)
        bs = np.linspace(1, 3e9, 100)
        g, dt = misst_protocol(30, bs, self.t(1000))
        misst = np.loadtxt(ORACLES / "misst_cylinder_signal_smalldelta_30ms_"
                           "bigdelta_40ms_radius_5um.txt")
        n = self.n(1e4)
        runs = {}
        spread = self.meta.setdefault("nsv_signal_max_abs_diff", {})
        for p in periodic:
            for pad in padding:
                signals = []
                for n_sv in n_svs:
                    sub = substrates.mesh(
                        m["vertices"], m["faces"], p,
                        padding=np.full(3, 2e-6 * pad), init_pos="intra",
                        n_sv=np.array(n_sv), quiet=True,
                    )
                    (s, pos), run = self.simulate(n, D, g, dt, sub,
                                                  final_pos=True, dtype=dtype)
                    key = mesh_key(p, pad, n_sv)
                    self.record(key, np.abs(s / n - misst).max(),
                                MISST_THRESHOLD, run)
                    # Radial leak: the cylinder's axis is z through the
                    # voxel's centre.
                    c = np.asarray(sub.voxel_size) / 2
                    r = np.linalg.norm((pos - c)[:, :2], axis=1)
                    self.record(key + "_leak", float(r.max() / 5e-6) - 1.0,
                                LEAK_THRESHOLD)
                    runs[key] = (s, pos)
                    self.substrates[key] = sub
                    signals.append(s)
                spread[f"p{int(p)}_pad{int(pad)}"] = float(max(
                    np.abs(s - signals[0]).max() for s in signals))
        return runs

    def neuron(self, dts=NEURON_DTS):
        """The neuron mesh (29,688 triangles, non-periodic, n_sv 20^3): no
        spin may end outside the voxel, at each step duration."""
        with open(ORACLES / "neuron-model.pkl", "rb") as f:
            nm = pickle.load(f)
        n = self.n(2e3)
        for dt_n in dts:
            sub = substrates.mesh(
                nm["vertices"], nm["faces"], False, init_pos="intra",
                n_sv=np.array([20, 20, 20]), quiet=True,
            )
            g = np.zeros((1, self.t(100), 3))
            (_, pos), run = self.simulate(n, D, g, dt_n, sub, final_pos=True)
            inside = np.all(
                (pos >= -1e-12) & (pos <= np.asarray(sub.voxel_size) + 1e-12),
                axis=1,
            )
            self.record(f"neuron_leak_dt{dt_n:g}", float((~inside).sum()),
                        1.0, run)

    def exchange(self):
        """Exchange and relaxation: the fused transit counts against the
        relaxation weights, the permeable analytic sphere, uniform T2.
        Returns {"cell": (substrate, exchange stats, run), "sphere":
        (exchange stats, run)}."""
        with open(ORACLES / "cylinder_mesh_closed.pkl", "rb") as f:
            m = pickle.load(f)
        n, n_t, dt = self.n(1e5), self.t(200), 2e-4
        g0 = np.zeros((1, n_t, 3))
        t2i, t2e = 25e-3, 150e-3
        sub = substrates.mesh(
            m["vertices"], m["faces"], True, init_pos="intra",
            n_sv=np.array([10, 10, 10]), quiet=True, perm_prob=0.2,
        )
        (sig, stats), run = self.simulate(
            n, D, g0, dt, sub, seed=7, relaxation=(t2i, t2e),
            exchange_stats=True)

        def weight_gap(sig, stats):
            k = stats["intra_steps"].astype(float)
            w = np.exp(-(dt / t2i) * k - (dt / t2e) * (n_t - k))
            return abs(float(sig[0]) - w.sum()) / w.sum()

        mean_c = float(stats["crossings"].mean())
        self.record("fused_exchange_weight_consistency",
                    weight_gap(sig, stats), 1e-4, run,
                    {"mean_crossings": mean_c})
        stats_cell, run_cell = stats, run
        self.record("fused_exchange_rate_nonzero", 1.0 / max(mean_c, 1e-9),
                    10.0)

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            (sig, pos, stats), run = self.simulate(
                n, D, g0, dt, substrates.sphere(5e-6, perm_prob=0.3), seed=7,
                final_pos=True, relaxation=(t2i, t2e), exchange_stats=True)
        self.record("perm_sphere_weight_consistency", weight_gap(sig, stats),
                    1e-4, run)
        frac_out = float((np.linalg.norm(pos, axis=1) > 5e-6).mean())
        self.record("perm_sphere_escape", 1.0 - frac_out, 1.0, None,
                    {"frac_outside": frac_out})
        runs = {"cell": (sub, stats_cell, run_cell), "sphere": (stats, run)}

        bfree = np.linspace(1, 2e9, 100)
        g, dt_f = gradients.pgse(20e-3, 40e-3, self.t(500), bfree[:10],
                                 np.tile([[1.0, 0, 0]], (10, 1)))
        n_f, t2 = self.n(2e4), 80e-3
        base, _ = self.simulate(n_f, D, g, dt_f, substrates.free(), seed=3)
        weighted, run = self.simulate(n_f, D, g, dt_f, substrates.free(),
                                      seed=3, relaxation=t2)
        self.record("uniform_t2_exact", np.abs(
            weighted / base - np.exp(-g.shape[1] * dt_f / t2)).max(), 1e-5,
            run)
        return runs

    def finish(self, commit=None):
        """Fill ``_meta`` and write the results; returns all_pass."""
        meta = self.meta
        meta["device"] = str(self.device)
        if torch.device(self.device).type == "cuda":
            meta["card"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True, timeout=60).stdout.strip().splitlines()[0]
            meta["kind"] = torch.cuda.get_device_name(0)
            from disimpy_tpu_torch.engine import _build

            meta["nvcc"] = subprocess.run(
                [_build._nvcc(), "--version"], capture_output=True,
                text=True, check=True).stdout.strip().splitlines()[-1]
        meta["torch"] = torch.__version__
        meta["cuda"] = torch.version.cuda
        meta["commit"] = commit or _commit()
        meta["spins_scale"], meta["steps_scale"] = self.spins, self.steps
        meta["elapsed_s"] = round(time.time() - self.t_start, 1)
        meta["all_pass"] = all(v["pass"] for v in self.results.values())
        self.write()
        return meta["all_pass"]

    def write(self):
        if self.out is not None:
            with open(self.out, "w") as f:
                json.dump({**self.results, "_meta": self.meta}, f, indent=1)


def _commit():
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
            text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown (not a git checkout; pass --commit)"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(ROOT / "PARITY_torch.json"))
    ap.add_argument("--groups", default=",".join(GROUPS))
    ap.add_argument("--spins", type=float, default=1.0,
                    help="scale of every spin count (1: full size)")
    ap.add_argument("--steps", type=float, default=1.0,
                    help="scale of every step count (1: full size)")
    ap.add_argument("--commit", default=None)
    args = ap.parse_args(argv)
    groups = args.groups.split(",")
    unknown = set(groups) - set(GROUPS)
    if unknown:
        ap.error(f"unknown groups {sorted(unknown)}")
    parity = Parity(args.device, args.spins, args.steps, args.out)
    for name in GROUPS:
        if name in groups:
            getattr(parity, name)()
    ok = parity.finish(args.commit)
    print(f"{args.out} written;", "ALL PASS" if ok else "FAILURES PRESENT")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
