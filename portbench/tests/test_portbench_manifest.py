"""BENCHMARK.json keeps the contract's rules, and the harness finds a
configuration, a cell and a metric added as new files and entries only."""

import copy
import json
import os
import shutil
import subprocess
import sys

import pytest

from harness import manifest

BENCH_DIR = manifest.BENCH_DIR
ROOT = manifest.root_of()


def test_benchmark_json_keeps_the_rules():
    assert manifest.problems(manifest.load()) == []


def test_every_cell_finds_its_files():
    m = manifest.load()
    for w in m["workloads"]:
        _, config = manifest.cell(m, w["name"])
        sizes, builder = manifest.config_builder(config)
        assert hasattr(builder, "build") and sizes["reduced"] == config[
            "reduced"]
        traffic = manifest.read_json("traffic", w["traffic"] + ".json")
        assert traffic["dtype"] in ("float32", "float64")
        limits = manifest.read_json("limits", w["name"] + ".json")
        assert limits["signal_gap"]["limit"] > 0
        for trace in (False, True):
            for metric in manifest.metrics_of(m, w["name"], trace):
                assert hasattr(manifest.metric_reader(metric["name"]), "read")


@pytest.mark.parametrize("breach", [
    ("name", "bad name"), ("unit", "tokens per second"),
    ("unit", "x" * 17), ("workloads", None), ("moves", "setup_sx"),
    ("four_chips", None), ("bound", 0.3)])
def test_problems_finds_each_breach(breach):
    m = copy.deepcopy(manifest.load())
    key, value = breach
    layer = m["per_layer"][0]
    if key == "name":
        layer["name"] = value
    elif key == "unit":
        layer["unit"] = value
    elif key == "workloads":
        del layer["workloads"]
    elif key == "moves":
        layer["moves"] = value
    elif key == "four_chips":
        m["workloads"][0]["chips"] = 4
        m["workloads"][1]["chips"] = 4
    elif key == "bound":
        m["end_to_end"][0]["bound"] = value
    assert manifest.problems(m)


def test_metric_must_list_cells_that_report_what_it_moves():
    m = copy.deepcopy(manifest.load())
    m["end_to_end"][1]["workloads"] = ["cylinder.fused"]
    m["per_layer"][0]["moves"] = m["end_to_end"][1]["name"]
    assert any("listed cell" in p for p in manifest.problems(m))


def _add_files(tree):
    """A configuration, a traffic mix, a cell and a metric added as new
    files and entries only."""
    bench = os.path.join(tree, "portbench")
    with open(os.path.join(bench, "configs", "coarse.json"), "w") as f:
        json.dump({"name": "coarse", "mesh_file": "cylinder_mesh.npz",
                   "periodic": True, "n_sv": [4, 4, 4], "reduced": []}, f)
    shutil.copy(os.path.join(bench, "configs", "cylinder.py"),
                os.path.join(bench, "configs", "coarse.py"))
    traffic = manifest.read_json("traffic", "classic-f64.json")
    traffic.update(n_walkers=256, n_t=8, compare_calls=1, trace_calls=1)
    with open(os.path.join(bench, "traffic", "tiny-f64.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(bench, "limits", "coarse.tiny-f64.json"),
              "w") as f:
        json.dump({"signal_gap": {"limit": 1e-9},
                   "position_share": {"limit": 0.0}}, f)
    with open(os.path.join(bench, "metrics", "calls_traced.py"), "w") as f:
        f.write("def read(ctx):\n    return len(ctx.calls)\n")
    path = os.path.join(tree, "BENCHMARK.json")
    m = manifest.load(tree)
    m["configs"].append({"name": "coarse", "source": "https://example.org",
                         "file": "portbench/configs/coarse.json",
                         "reduced": [], "why": "a coarse cylinder grid"})
    m["workloads"].append({"name": "coarse.tiny-f64", "config": "coarse",
                           "traffic": "tiny-f64", "chips": 1,
                           "why": "a tiny cell"})
    m["per_layer"].append({"name": "calls_traced", "unit": "calls",
                           "better": "higher", "source": "host_clock",
                           "layer": "driver", "moves": "spin_steps_per_s",
                           "workloads": ["coarse.tiny-f64"]})
    with open(path, "w") as f:
        json.dump(m, f)
    return m


def test_new_files_make_a_new_cell(tmp_path):
    tree = str(tmp_path)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tree)
    shutil.copytree(BENCH_DIR, os.path.join(tree, "portbench"),
                    ignore=shutil.ignore_patterns(".home", ".cache", "out",
                                                  "__pycache__"))
    m = _add_files(tree)
    assert manifest.problems(m) == []
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {os.path.join(tree, 'portbench')!r})\n"
        "import run\n"
        "for trace in (False, True):\n"
        "    r = run.run('coarse.tiny-f64', 5, 0.2, trace, device='cpu')\n"
        "    print(json.dumps(r))\n")
    env = dict(os.environ, HOME=tree, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600, cwd=tree)
    assert out.returncode == 0, out.stderr[-3000:]
    timed, traced = (json.loads(line) for line in
                     out.stdout.strip().splitlines()[-2:])
    assert timed["correct"] is True and traced["correct"] is True
    assert set(timed["metrics"]) == {"spin_steps_per_s", "call_p95_ms",
                                     "setup_s"}
    assert traced["metrics"] == {"calls_traced": {"value": 1.0,
                                                  "unit": "calls"}}
