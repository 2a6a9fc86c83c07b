"""Run bench.py's two workloads through simulation() at the default knobs,
and hold two trees' runs to each other bit for bit.

    python3 scripts/default_runs.py run TREE OUT.npz [--device cuda]
        [--spins 524288] [--steps 150] [--workloads bundle,neuron]
    python3 scripts/default_runs.py compare A.npz B.npz

``run`` imports ``disimpy_tpu_torch`` from TREE (a checkout, such as one
unpacked with ``git archive`` of another commit) and saves each workload's
signals and final positions (seed 2, bench.py's 32-measurement PGSE
waveform) to OUT. ``compare`` prints, per array, whether two such files are
equal bit for bit, and exits 1 if any differs. Give each ``run`` a fresh
``HOME``, so that neither tree reads the other's pack cache.
"""

import argparse
import os
import pickle
import sys

import numpy as np


def run(args):
    root = os.path.abspath(args.tree)
    sys.path.insert(0, root)
    from disimpy_tpu_torch import gradients, meshes, simulations, substrates

    if not simulations.__file__.startswith(root):
        raise SystemExit(f"imported {simulations.__file__}, not {root}")
    dt = 1.3e-5
    step_l = float(np.sqrt(6 * 2e-9 * dt))
    subs = {}
    if "bundle" in args.workloads:
        v, f = meshes.cylinder_array_mesh(
            1.5e-6, 4e-6, grid=(8, 8), length=32e-6, n_facets=32,
            n_segments=25)
        n_sv = max(1, int(4e-6 * 8 / (4.2 * step_l)))
        subs["bundle"] = substrates.mesh(
            v, f, periodic=True, n_sv=np.array([n_sv] * 3), quiet=True)
    if "neuron" in args.workloads:
        with open(os.path.join(root, "tests", "oracles", "neuron-model.pkl"),
                  "rb") as fh:
            m = pickle.load(fh)
        subs["neuron"] = substrates.mesh(
            np.asarray(m["vertices"], dtype=np.float64),
            np.asarray(m["faces"]), periodic=True, quiet=True)
    bvals = np.linspace(1e8, 3e9, 32)
    g, _ = gradients.pgse(1e-3, dt * args.steps - 1e-3, args.steps, bvals,
                          np.tile([[1.0, 0.0, 0.0]], (32, 1)))
    out = {}
    for name, sub in subs.items():
        s, p = simulations.simulation(
            args.spins, 2e-9, g, dt, sub, seed=2, quiet=True, final_pos=True,
            device=args.device)
        out[name + "_signals"], out[name + "_pos"] = s, p
    np.savez(args.out, **out)
    print(f"{root}: " + ", ".join(
        f"{k} sum |x| {float(np.abs(v).sum())!r}" for k, v in out.items()))


def compare(args):
    a, b = np.load(args.a), np.load(args.b)
    same = True
    for k in sorted(set(a.files) | set(b.files)):
        equal = (k in a.files and k in b.files and a[k].shape == b[k].shape
                 and a[k].tobytes() == b[k].tobytes())
        same &= equal
        print(f"{k}: {'equal bit for bit' if equal else 'DIFFERENT'}")
    return 0 if same else 1


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("tree")
    r.add_argument("out")
    r.add_argument("--device", default="cuda")
    r.add_argument("--spins", type=int, default=524288)
    r.add_argument("--steps", type=int, default=150)
    r.add_argument("--workloads", default="bundle,neuron")
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = ap.parse_args()
    if args.cmd == "run":
        args.workloads = args.workloads.split(",")
        run(args)
        return 0
    return compare(args)


if __name__ == "__main__":
    sys.exit(main())
