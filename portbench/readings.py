"""Readings that a cell's correctness limit is set from (not run by the
benchmark's own runs).

    python3 portbench/readings.py --workload <cell> --seeds <s1,s2,...> \
        [--control-seeds <k>] [--faults <f1,f2,...>] [--fault-seeds <k>] \
        [--out <file.json>]

In one process: the cell's set-up as a benchmark run makes it, then for
each seed one call of the program and the plain reference of that call
(the numbers the benchmark compares, ``stats.COMPARED``), and for the
first ``--control-seeds`` seeds the control: the reference computed in the
precision below the configured one (``limits/<cell>.json``'s
``control``) in the program's place, against the reference. Then each
fault of ``faults.py`` named in ``--faults`` on the first
``--fault-seeds`` seeds, each a whole ``run.run`` of the cell at its own
size with the fault planted under the timed call, judged by the run's own
comparison. A number's limit lies above its largest program reading and
below the smallest reading of the control or fault it is to catch.
"""

import argparse
import json
import os
import sys
import time

import run  # noqa: F401  (sets the path and the cache environment)
import faults
from harness import manifest as bench_manifest
from harness import stats, waveforms


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--faults", default="")
    parser.add_argument("--fault-seeds", type=int, default=3)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    for key, value in run.CACHE_ENV.items():
        os.environ[key] = value

    import torch

    from disimpy_tpu_torch import simulations, substrates
    from reference import walk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    seeds = [int(s) for s in args.seeds.split(",")]
    _, workload, traffic, limits, sizes, builder = run._cell(args.workload, {})
    n = traffic["n_walkers"]
    vertices, faces, sub_kwargs = builder.build(sizes, traffic)
    gradient = waveforms.make(traffic)
    substrate = substrates.mesh(vertices, faces, quiet=True, **sub_kwargs)
    outputs = {}
    for seed in seeds:
        outputs[seed] = simulations.simulation(
            n, traffic["diffusivity"], gradient, traffic["dt"], substrate,
            seed=seed, dtype=traffic["dtype"], device="cuda",
            **traffic["simulation"])
    substrate = None
    torch.cuda.empty_cache()
    control = limits["control"]
    common = (vertices, faces, n, traffic["diffusivity"], gradient,
              traffic["dt"])
    semantics = (sub_kwargs["init_pos"], traffic["engine"],
                 getattr(torch, traffic["dtype"]))
    padding = sub_kwargs.get("padding", (0.0, 0.0, 0.0))

    rows = []
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        ref = walk.simulate(*common, seed, *semantics, device="cuda",
                            padding=padding)
        ref_s = time.perf_counter() - t0
        signal, positions = outputs[seed]
        row = {"seed": seed,
               "program": stats.compared(signal, positions, ref, n),
               "reference_s": ref_s}
        if i < args.control_seeds:
            t0 = time.perf_counter()
            low = walk.simulate(*common, seed, *semantics,
                                dtype=getattr(torch, control["dtype"]),
                                device="cuda", padding=padding,
                                max_iter=control.get("max_iter", 1000))
            row["control"] = stats.compared(low.signal, low.positions, ref, n)
            row["control_s"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        rows.append(row)
    for name in filter(None, args.faults.split(",")):
        for seed in seeds[:args.fault_seeds]:
            t0 = time.perf_counter()
            result = run.run(args.workload, seed, 0.0, False,
                             program=faults.FAULTS[name])
            row = {"seed": seed, "fault": name,
                   "numbers": {k: c["value"]
                               for k, c in result["checks"].items()},
                   "correct": result["correct"],
                   "run_s": time.perf_counter() - t0}
            print(json.dumps(row), flush=True)
            rows.append(row)
    summary = {"workload": args.workload, "rows": rows}
    for key in stats.COMPARED:
        program = [r["program"][key] for r in rows if "program" in r]
        summary[key] = {"lower": max(program),
                        "limit": limits[key]["limit"]}
        control = [r["control"][key] for r in rows if "control" in r]
        if control:
            summary[key]["control"] = min(control)
        for name in filter(None, args.faults.split(",")):
            summary[key][name] = min(r["numbers"][key] for r in rows
                                     if r.get("fault") == name)
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
