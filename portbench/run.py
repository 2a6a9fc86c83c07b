"""The benchmark of the PyTorch + CUDA port: one cell, one process.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell (an entry of BENCHMARK.json's ``workloads``) is a configuration
(``configs/<config>.json`` and the builder beside it) under a traffic mix
(``traffic/<traffic>.json``). Every call is a whole ``simulation()`` on one
substrate built in set-up by the builder's ``substrate(sizes, traffic)``,
with the same arguments and the next seed: a closed loop with one caller,
as a researcher averaging seeds runs it.

Set-up (imports, CUDA, the kernels' build or load, the substrate, the pack
and one warm-up call that captures the CUDA graphs) ends at the first timed
call. With ``--trace 0`` the window runs calls for ``--seconds`` and the
result carries the cell's end-to-end metrics; with ``--trace 1`` a few
calls run under torch.profiler and it carries the per-layer metrics, each
read by ``metrics/<metric>.py``. Either way, once the window has closed and
the program's state is freed, the plain reference (the builder's
``reference(...)``: for a mesh, ``reference/walk.py``) recomputes a sample
of the window's calls, drawn from the seed, and
``correct`` says whether each compared number of every one (the signals'
widest gap, the share of spins whose final position departs) is within the
cell's limit (``limits/<cell>.json``). The result is the last line of
standard output.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# The program's caches live at fixed paths inside the checkout: the fused
# pack's disk cache under HOME, which the run points here, and the built
# kernels in the program's own package (disimpy_tpu_torch/build/).
CACHE_ENV = {"HOME": os.path.join(BENCH_DIR, ".home")}
FORBIDDEN = ("jax", "jaxlib", "flax", "disimpy_tpu")
OUT_DIR = os.path.join(BENCH_DIR, "out")

sys.path[:0] = [BENCH_DIR, ROOT]

from harness import manifest as bench_manifest  # noqa: E402
from harness import stats, trace, waveforms  # noqa: E402


def forbidden_modules():
    """Modules loaded whose top-level name is JAX's, Flax's or the JAX
    package's (names compared whole: ``disimpy_tpu_torch`` is not
    ``disimpy_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def say(msg):
    print(msg, file=sys.stderr, flush=True)


def _card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


def _cell(name, overrides):
    manifest = bench_manifest.load(ROOT)
    workload, config = bench_manifest.cell(manifest, name)
    traffic = bench_manifest.read_json("traffic",
                                       workload["traffic"] + ".json")
    limits = bench_manifest.read_json("limits", name + ".json")
    sizes, builder = bench_manifest.config_builder(config, ROOT)
    traffic.update(overrides.get("traffic", {}))
    sizes.update(overrides.get("sizes", {}))
    return manifest, workload, traffic, limits, sizes, builder


def call_kwargs(traffic, seed, device):
    """The keyword arguments of one call's ``simulation()``. A traffic that
    splits the spins over cards names them (``devices``), which the
    program then takes in place of ``device``."""
    kwargs = dict(traffic["simulation"], seed=seed, dtype=traffic["dtype"])
    if "devices" not in kwargs:
        kwargs["device"] = device
    return kwargs


def run(name, seed, seconds, trace_on, device="cuda", overrides=None,
        program=None):
    """One run of cell ``name``; returns the result line as a dict.

    ``overrides`` ({"traffic": {...}, "sizes": {...}}) and ``device``
    serve the harness's own tests (a tiny cell on the CPU); ``program``
    replaces the call under test by ``program(simulation, *args,
    **kwargs)``, which the tests use to break it.
    """
    import numpy as np
    import torch

    manifest, workload, traffic, limits, sizes, builder = _cell(
        name, overrides or {})
    from disimpy_tpu_torch import simulations

    metrics = bench_manifest.metrics_of(manifest, name, trace_on)
    readers = {m["name"]: bench_manifest.metric_reader(m["name"])
               for m in metrics}
    n, n_t = traffic["n_walkers"], traffic["n_t"]
    dtype = traffic["dtype"]
    cards = workload["chips"]
    gradient = waveforms.make(traffic)
    substrate = builder.substrate(sizes, traffic)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            trace.synchronize(cards)

    def call(call_seed):
        args = (n, traffic["diffusivity"], gradient, traffic["dt"],
                substrate)
        kwargs = call_kwargs(traffic, call_seed, device)
        t0 = time.perf_counter()
        if program is None:
            out = simulations.simulation(*args, **kwargs)
        else:
            out = program(simulations.simulation, *args, **kwargs)
        sync()
        wall = time.perf_counter() - t0
        signal, positions = out if isinstance(out, tuple) else (out, None)
        return signal, positions, wall

    ctx = types.SimpleNamespace(
        traffic=traffic, n_walkers=n, n_t=n_t, dtype=dtype, call=call,
        substrate=substrate, calls=[], reference={})
    # The calls compared: a uniform sample of the window's calls, drawn
    # from the seed as they finish (reservoir sampling), with their final
    # positions.
    rng = np.random.default_rng(seed)
    n_compare = traffic["compare_calls"]
    sample = []
    call(seed)  # warm-up: packs, builds, captures the graphs
    ctx.setup_s = time.perf_counter() - T_START
    say(f"{name}: set-up {ctx.setup_s:.3f} s")

    def one(k):
        call_seed = seed + k
        if cuda and trace_on:
            with torch.profiler.record_function("portbench.call"):
                signal, positions, wall = call(call_seed)
        else:
            signal, positions, wall = call(call_seed)
        i = len(ctx.calls)
        ctx.calls.append((call_seed, wall, np.asarray(signal, dtype=float)))
        if i < n_compare:
            sample.append((i, positions))
        else:
            j = int(rng.integers(0, i + 1))
            if j < n_compare:
                sample[j] = (i, positions)

    if trace_on:
        def traced_calls():
            with torch.profiler.record_function("portbench.window"):
                for k in range(1, traffic["trace_calls"] + 1):
                    one(k)

        if cuda:
            device_ev, host_ev, ctx.window_s = trace.traced(traced_calls,
                                                            cards)
        else:
            t0 = time.perf_counter()
            traced_calls()
            device_ev, host_ev, ctx.window_s = [], [], time.perf_counter() - t0
        ctx.kernels = trace.kernel_table(device_ev)
        ctx.busy_s = trace.busy_seconds(device_ev, cards)
        ctx.card_busy_s = trace.card_busy(device_ev, cards)
        ctx.events = sum(c for _, c in ctx.kernels.values())
        bounds = [(s, e) for nm, s, e in host_ev if nm == "portbench.window"]
        first, last = bounds[0] if bounds else (None, None)
        ctx.gaps = trace.idle_gaps(device_ev, host_ev, first, last)
    else:
        t0 = time.perf_counter()
        k = 1
        while True:
            one(k)
            k += 1
            if time.perf_counter() - t0 >= seconds:
                break
        ctx.window_s = time.perf_counter() - t0
    peak = trace.memory_peak(cards) if cuda else 0

    for reader in readers.values():
        if hasattr(reader, "prepare"):
            reader.prepare(ctx)

    # The program's state goes before the reference runs.
    ctx.call = ctx.substrate = substrate = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    readings = {key: [] for key in stats.COMPARED}
    t_ref = time.perf_counter()
    for i, positions in sorted(sample, key=lambda item: item[0]):
        call_seed, _, signal = ctx.calls[i]
        out = builder.reference(
            sizes, traffic, call_seed, gradient,
            cfg_dtype=getattr(torch, dtype), dtype=torch.float64,
            device=device, work=trace_on,
            max_iter=traffic["simulation"].get("max_iter", 1000))
        ctx.reference[call_seed] = out
        for key, value in stats.compared(signal, positions, out, n).items():
            readings[key].append(value)
    ref_s = time.perf_counter() - t_ref
    say(f"{name}: reference over {len(sample)} calls in {ref_s:.3f} s; "
        f"{readings}")

    values = {}
    for m in metrics:
        value = readers[m["name"]].read(ctx)
        if value is None:
            say(f"{name}: {m['name']} found nothing to read and is left out")
            continue
        values[m["name"]] = {"value": float(value), "unit": m["unit"]}
    failed = sum(not np.all(np.isfinite(s)) for _, _, s in ctx.calls)
    checks = {}
    for key, read in readings.items():
        checks[key] = {"value": max(read) if read else float("inf"),
                       "limit": limits[key]["limit"]}
    correct = bool(failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values()))
    result = {
        "correct": correct,
        "attempted": len(ctx.calls),
        "failed": int(failed),
        "metrics": values,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": workload["chips"],
            "memory_peak_bytes": int(peak),
        },
    }
    if trace_on:
        result["device"]["busy_s"] = ctx.busy_s
        result["device"]["window_s"] = ctx.window_s
        result["breakdown"] = trace.breakdown(ctx.kernels, ctx.gaps)
        _write_trace(name, seed, ctx)
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)
    return result


class ForbiddenImport(RuntimeError):
    pass


def _write_trace(name, seed, ctx):
    """The traced window's kernel table, for reading beside the result."""
    os.makedirs(OUT_DIR, exist_ok=True)
    table = sorted(ctx.kernels.items(), key=lambda kv: -kv[1][0])
    for k, (s, c) in table[:25]:
        say(f"  kernel {trace.kernel_id(k)[:60]}: {s * 1e3:.4f} ms, {c} "
            f"events over {len(ctx.calls)} calls")
    path = os.path.join(OUT_DIR, f"{name}-{seed}-trace.json")
    with open(path, "w") as f:
        json.dump({"calls": len(ctx.calls), "window_s": ctx.window_s,
                   "busy_s": ctx.busy_s, "card_busy_s": ctx.card_busy_s,
                   "gaps": ctx.gaps,
                   "kernels": {k: list(v) for k, v in table}}, f, indent=1)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for key, value in CACHE_ENV.items():
        os.environ[key] = value
    os.makedirs(CACHE_ENV["HOME"], exist_ok=True)

    import torch

    manifest = bench_manifest.load(ROOT)
    workload, _ = bench_manifest.cell(manifest, args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < workload["chips"]):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        say(f"{args.workload} needs {workload['chips']} CUDA device(s); "
            f"found {found}")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    say(f"card: {_card_line()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    except ForbiddenImport as e:
        say(f"modules of JAX or the JAX package were loaded: {e.args[0]}")
        return 3
    for key, check in result["checks"].items():
        say(f"check {key} {check['value']!r} limit {check['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
