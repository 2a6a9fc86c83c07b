"""BENCHMARK.json: loading, the rules it keeps, and what belongs to a cell.

Everything the harness runs is found by name: a cell's configuration file
and builder (``configs/<config>.json`` and ``configs/<config>.py``), its
traffic (``traffic/<traffic>.json``), its correctness limits
(``limits/<cell>.json``) and each metric's reader (``metrics/<metric>.py``).
"""

import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = ("command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer")
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def root_of(bench_dir=BENCH_DIR):
    """The checkout's root: the directory that holds BENCHMARK.json."""
    return os.path.dirname(bench_dir)


def load(root=None):
    with open(os.path.join(root or root_of(), "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


def problems(manifest):
    """Every rule of the benchmark's contract that ``manifest`` breaks, as
    a list of messages (empty when it keeps them all)."""
    out = []
    if tuple(manifest) != TOP_KEYS:
        out.append(f"top-level keys {list(manifest)}")
    cmd, paths = manifest.get("command", []), manifest.get("paths", [])
    if not (1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)):
        out.append("command")
    if not (1 <= len(paths) <= 16 and all(
            PATH.match(p) and not p.startswith("/") and ".." not in p
            for p in paths)):
        out.append("paths")
    rs = manifest.get("run_seconds")
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        out.append("run_seconds")
    names = set()

    def name_ok(kind, entry, keys, extra=()):
        name = entry.get("name", "")
        if not NAME.match(name):
            out.append(f"{kind} name {name!r}")
        if name in names:
            out.append(f"duplicate name {name!r}")
        names.add(name)
        allowed = keys | set(extra)
        if not keys <= set(entry) <= allowed:
            out.append(f"{kind} {name}: keys {sorted(entry)}")

    configs = manifest.get("configs", [])
    workloads = manifest.get("workloads", [])
    e2e = manifest.get("end_to_end", [])
    layers = manifest.get("per_layer", [])
    if not 1 <= len(configs) <= 24:
        out.append("number of configs")
    for c in configs:
        name_ok("config", c, CONFIG_KEYS)
        if not (_line(c.get("source")) and _line(c.get("why"))):
            out.append(f"config {c.get('name')}: source or why")
        if not any(c["file"].startswith(p.rstrip("/") + "/") for p in paths):
            out.append(f"config {c.get('name')}: file outside paths")
        reduced = c.get("reduced", [])
        if len(reduced) > 16 or not all(NAME.match(k) for k in reduced):
            out.append(f"config {c.get('name')}: reduced")
    files = [c["file"] for c in configs]
    if len(set(files)) != len(files):
        out.append("two configs share a file")
    if not 1 <= len(workloads) <= 24:
        out.append("number of workloads")
    pairs = set()
    for w in workloads:
        name_ok("workload", w, WORKLOAD_KEYS)
        if not (NAME.match(w.get("config", ""))
                and NAME.match(w.get("traffic", ""))):
            out.append(f"workload {w.get('name')}: config or traffic name")
        if w.get("chips") not in (1, 4):
            out.append(f"workload {w.get('name')}: chips")
        if not _line(w.get("why")):
            out.append(f"workload {w.get('name')}: why")
        pair = (w.get("config"), w.get("traffic"))
        if pair in pairs:
            out.append(f"workload {w.get('name')}: pair repeated")
        pairs.add(pair)
    four = sum(w.get("chips") == 4 for w in workloads)
    if four > max(len(workloads) // 4, 1):
        out.append("too many four-chip cells")
    used = {w.get("config") for w in workloads}
    if used != {c["name"] for c in configs}:
        out.append("every config is used by some cell, and only those")
    cells = {w["name"] for w in workloads}
    if not 1 <= len(e2e) <= 16:
        out.append("number of end-to-end metrics")
    if not 1 <= len(layers) <= 128:
        out.append("number of per-layer metrics")
    reports = {}
    for m in e2e:
        name_ok("metric", m, E2E_KEYS, ("workloads",))
        bound = m.get("bound")
        if not (isinstance(bound, (int, float)) and 0.01 <= bound <= 0.25):
            out.append(f"metric {m.get('name')}: bound")
        if m.get("source") not in ("host_clock", "device_trace"):
            out.append(f"metric {m.get('name')}: source")
        reports[m["name"]] = set(m.get("workloads", cells))
    if "setup_s" not in reports:
        out.append("no setup_s")
    for cell in cells:
        if not any(cell in ws for k, ws in reports.items() if k != "setup_s"):
            out.append(f"{cell} reports no end-to-end metric besides setup_s")
    layer_names = {}
    for m in layers:
        name_ok("metric", m, LAYER_KEYS, ("workloads",))
        if m.get("source") not in ("device_trace", "program_span",
                                   "program_counter", "host_clock"):
            out.append(f"metric {m.get('name')}: source")
        if not _line(m.get("layer")):
            out.append(f"metric {m.get('name')}: layer")
        moved = reports.get(m.get("moves"))
        if moved is None:
            out.append(f"metric {m.get('name')}: moves {m.get('moves')!r}")
            continue
        listed = set(m.get("workloads", moved))
        if "workloads" not in m:
            out.append(f"metric {m.get('name')}: no workloads list")
        if not listed <= moved or not listed <= cells:
            out.append(f"metric {m.get('name')}: a listed cell does not "
                       "report what it moves")
        for cell in listed:
            layer_names.setdefault(cell, set()).add(m["name"])
    for m in e2e + layers:
        if not (UNIT.match(m.get("unit", ""))
                and m.get("better") in ("lower", "higher")):
            out.append(f"metric {m.get('name')}: unit or better")
    for cell in cells:
        if cell not in layer_names:
            out.append(f"{cell} reports no per-layer metric")
    if len(json.dumps(manifest, indent=1)) > 64 * 1024:
        out.append("larger than 64 KiB")
    return out


def cell(manifest, name):
    """The workload entry ``name`` and its configuration entry."""
    for w in manifest["workloads"]:
        if w["name"] == name:
            config = next(c for c in manifest["configs"]
                          if c["name"] == w["config"])
            return w, config
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(manifest, name, trace):
    """The metric entries cell ``name`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer metrics."""
    e2e = [m for m in manifest["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in moved
                             else [])]


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(*parts, bench_dir=BENCH_DIR):
    with open(os.path.join(bench_dir, *parts)) as f:
        return json.load(f)


def config_builder(config_entry, root=None):
    """(sizes, builder module) of a configuration: the JSON file that
    BENCHMARK.json names and the ``.py`` beside it."""
    path = os.path.join(root or root_of(), config_entry["file"])
    with open(path) as f:
        sizes = json.load(f)
    module = _module(os.path.splitext(path)[0] + ".py",
                     f"portbench_config_{config_entry['name']}")
    return sizes, module


def metric_reader(name, bench_dir=BENCH_DIR):
    """The module ``metrics/<name>.py``: ``read(ctx)`` gives the metric's
    value or None, and an optional ``prepare(ctx)`` runs while the program
    is still loaded."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    return _module(path, f"portbench_metric_{name.replace('.', '_')}")
