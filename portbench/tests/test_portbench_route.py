"""The one route from a configuration to the program and the reference: a
configuration's builder gives ``substrate(sizes, traffic)`` and
``reference(...)``. The mesh configurations hand the program and the
reference what a direct ``meshfile.build`` gives them; a geometry that is
not a mesh (free space) is added as new files only and runs correct, and
each fault reads it as not correct; a traced run over several cards is
read card by card."""

import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import faults
import run
from harness import manifest, meshfile, trace, waveforms
from reference import walk
from tiny import TINY

BENCH_DIR = manifest.BENCH_DIR
ROOT = manifest.root_of()
CELLS = ("cylinder.fused", "neuron.fused", "cylinder.classic-f64",
         "neuron.classic-f64")


@pytest.mark.parametrize("path", ["run.py", "readings.py",
                                  "tests/test_portbench_card.py"])
def test_harness_reaches_program_and_reference_only_through_the_builder(
        path):
    with open(os.path.join(BENCH_DIR, path)) as f:
        source = f.read()
    assert not re.search(r"substrates\.mesh\(|walk\.simulate\(", source)
    assert "builder.substrate(" in source and "builder.reference(" in source


@pytest.mark.parametrize("cell", CELLS)
def test_mesh_route_hands_on_the_same_arrays(monkeypatch, cell):
    from disimpy_tpu_torch import substrates

    _, _, traffic, _, sizes, builder = run._cell(cell, TINY)
    n = traffic["n_walkers"]
    v, f, kwargs = meshfile.build(sizes, n)
    seen = []
    monkeypatch.setattr(substrates, "mesh",
                        lambda *a, **k: seen.append((a, k)) or "mesh")
    assert builder.substrate(sizes, traffic) == "mesh"
    (args, got), = seen
    assert len(args) == 2 and np.array_equal(args[0], v)
    assert np.array_equal(args[1], f)
    assert sorted(got) == sorted([*kwargs, "quiet"]) and got["quiet"]
    for key, value in kwargs.items():
        assert np.array_equal(got[key], value)

    g = waveforms.make(traffic)
    cfg = getattr(torch, traffic["dtype"])
    seed = 2**31 + 77
    out = builder.reference(sizes, traffic, seed, g, cfg_dtype=cfg,
                            dtype=torch.float64, device="cpu", work=True,
                            max_iter=1000)
    direct = walk.simulate(v, f, n, traffic["diffusivity"], g, traffic["dt"],
                           seed, kwargs["init_pos"], traffic["engine"], cfg,
                           device="cpu", work=True,
                           padding=kwargs.get("padding", np.zeros(3)))
    assert np.array_equal(out.signal, direct.signal)
    assert np.array_equal(out.positions, direct.positions)
    assert np.array_equal(out.voxel, direct.voxel)
    assert out.step == direct.step
    for mine, theirs in zip(out.work, direct.work):
        assert np.array_equal(mine, theirs)


# A configuration that is not a mesh: free space, with a plain reference of
# its own (every spin starts at the origin; the free path's draw stream).
FREE_BUILDER = '''"""Free diffusion, and its plain reference."""

import math

import numpy as np
import torch

from reference import walk


def substrate(sizes, traffic):
    from disimpy_tpu_torch import substrates

    return substrates.free()


def reference(sizes, traffic, seed, gradient, cfg_dtype, dtype, device,
              work, max_iter):
    n, dt = traffic["n_walkers"], traffic["dt"]
    step_l = math.sqrt(6.0 * traffic["diffusivity"] * dt)
    ids = torch.arange(n, dtype=torch.int64, device=device)
    key = (seed & 0x7FFFFFFF) ^ 0x66726565
    g_eff = torch.as_tensor((walk.GAMMA * dt * step_l)
                            * np.transpose(gradient, (1, 0, 2)),
                            dtype=dtype, device=device)
    pos = torch.zeros((3, n), dtype=dtype, device=device)
    phases = torch.zeros((gradient.shape[0], n), dtype=dtype, device=device)
    for t in range(traffic["n_t"]):
        pos = pos + walk.directions(key, t, ids, cfg_dtype).to(dtype)
        phases += g_eff[t] @ pos
    signal = torch.cos(phases).to(torch.float64).sum(dim=1).cpu().numpy()
    return walk.Walk(signal, pos.T.to(torch.float64).cpu().numpy() * step_l,
                     np.full(3, np.inf), step_l, None)
'''

FREE_RUNS = '''
import json, sys
sys.path.insert(0, {bench!r})
import faults, run
for trace in (False, True):
    print(json.dumps(run.run("free.tiny-f64", 2**31 + 5, 0.2, trace,
                             device="cpu")))
for name, fault in faults.FAULTS.items():
    r = run.run("free.tiny-f64", 2**31 + 6, 0.0, False, device="cpu",
                program=fault)
    print(json.dumps(dict(r, fault=name)))
'''


def _add_free(tree):
    """The free configuration, a tiny traffic mix, its cell and a metric
    added as new files and entries only."""
    bench = os.path.join(tree, "portbench")
    with open(os.path.join(bench, "configs", "free.json"), "w") as f:
        json.dump({"name": "free", "geometry": "free", "reduced": []}, f)
    with open(os.path.join(bench, "configs", "free.py"), "w") as f:
        f.write(FREE_BUILDER)
    traffic = manifest.read_json("traffic", "classic-f64.json")
    traffic.update(n_walkers=256, n_t=8, compare_calls=1, trace_calls=1)
    with open(os.path.join(bench, "traffic", "tiny-f64.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(bench, "limits", "free.tiny-f64.json"), "w") as f:
        json.dump({"signal_gap": {"limit": 1e-9},
                   "position_share": {"limit": 0.0}}, f)
    with open(os.path.join(bench, "metrics", "calls_traced.py"), "w") as f:
        f.write("def read(ctx):\n    return len(ctx.calls)\n")
    m = manifest.load(tree)
    m["configs"].append({"name": "free", "source": "https://example.org",
                         "file": "portbench/configs/free.json",
                         "reduced": [], "why": "free diffusion"})
    m["workloads"].append({"name": "free.tiny-f64", "config": "free",
                           "traffic": "tiny-f64", "chips": 1,
                           "why": "a tiny cell"})
    m["per_layer"].append({"name": "calls_traced", "unit": "calls",
                           "better": "higher", "source": "host_clock",
                           "layer": "driver", "moves": "spin_steps_per_s",
                           "workloads": ["free.tiny-f64"]})
    with open(os.path.join(tree, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    return m


@pytest.fixture(scope="module")
def free_runs(tmp_path_factory):
    """Two sound runs (untraced, traced) and one run under each fault of
    the free cell, in a copy of the tree with the new files."""
    tree = str(tmp_path_factory.mktemp("free_tree"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tree)
    shutil.copytree(BENCH_DIR, os.path.join(tree, "portbench"),
                    ignore=shutil.ignore_patterns(".home", ".cache", "out",
                                                  "__pycache__"))
    m = _add_free(tree)
    assert manifest.problems(m) == []
    env = dict(os.environ, HOME=tree, PYTHONPATH=ROOT)
    code = FREE_RUNS.format(bench=os.path.join(tree, "portbench"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600, cwd=tree)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(line) for line in out.stdout.strip().splitlines()
             if line.startswith("{")]
    return {"sound": lines[:2],
            "faults": {r["fault"]: r for r in lines[2:]}}


@pytest.mark.parametrize("traced", [False, True], ids=["timed", "traced"])
def test_a_free_cell_added_as_files_runs_correct(free_runs, traced):
    result = free_runs["sound"][traced]
    assert result["correct"] is True and result["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())
    if traced:
        assert result["metrics"] == {"calls_traced": {"value": 1.0,
                                                      "unit": "calls"}}
    else:
        assert set(result["metrics"]) == {"spin_steps_per_s", "call_p95_ms",
                                          "setup_s"}


@pytest.mark.parametrize("fault", list(faults.FAULTS))
def test_each_fault_reads_a_free_cell_incorrect(free_runs, fault):
    result = free_runs["faults"][fault]
    assert result["correct"] is False
    assert list(result)[-2:] == ["checks", "fault"]


def test_position_share_takes_the_plain_distance_without_a_voxel():
    """An infinite voxel side (a geometry that does not repeat) wraps
    nothing: a spin a million sides of a finite voxel away departs only
    where the side is infinite."""
    ref = np.zeros((4, 3))
    moved = ref + np.array([[3e6, 0, 0], [0, -30.0, 0], [0, 0, 0.001],
                            [0, 0, 0]])
    inf = np.full(3, np.inf)
    share = run.stats.position_share(moved, ref, inf, 0.5, 0.01)
    assert share == pytest.approx(0.5)
    mixed = np.array([3.0, np.inf, np.inf])
    assert run.stats.position_share(moved, ref, mixed, 0.5, 0.01) == \
        pytest.approx(0.25)


@pytest.mark.parametrize("kind", ["free", "sphere", "cylinder"])
def test_faults_work_on_substrates_without_given_starts(fresh_home, kind):
    """The unchanged window also stubs the classic engine that free and
    analytic geometries run; the half batch leaves their starts to the
    program."""
    from disimpy_tpu_torch import simulations, substrates

    sub = {"free": substrates.free,
           "sphere": lambda: substrates.sphere(5e-6),
           "cylinder": lambda: substrates.cylinder(
               5e-6, np.array([1.0, 0.0, 0.0]))}[kind]()
    traffic = dict(manifest.read_json("traffic", "classic-f64.json"), n_t=10)
    g = waveforms.make(traffic)
    n = 64
    args = (n, traffic["diffusivity"], g, traffic["dt"], sub)
    kwargs = dict(seed=2**31 + 3, dtype="float64", device="cpu", quiet=True,
                  final_pos=True)
    signal, positions = faults.unchanged(simulations.simulation, *args,
                                         **kwargs)
    assert np.all(signal == n)
    sound, _ = simulations.simulation(*args, **kwargs)
    assert not np.all(sound == n)
    signal, positions = faults.half_batch(simulations.simulation, *args,
                                          **kwargs)
    assert signal.shape == sound.shape and positions.shape == (n, 3)
    assert np.array_equal(positions[:n // 2], positions[n // 2:])


def test_busy_time_of_four_cards_is_their_mean():
    """Four cards busy at the same time in one 10 us window: the mean of
    their busy times, never over the window; the old sum of every event
    was about four windows."""
    window_s = 10e-6
    device = [("k", 0.0, 8.0, 8.0, card) for card in range(4)]
    device += [("j", 8.0, 9.0, 1.0, 1), ("j", 8.0, 10.0, 2.0, 2)]
    assert trace.card_busy(device, 4) == pytest.approx(
        [8e-6, 9e-6, 10e-6, 8e-6])
    busy = trace.busy_seconds(device, 4)
    assert busy == pytest.approx((8 + 9 + 10 + 8) * 1e-6 / 4)
    assert 0 < busy <= window_s
    old = sum(s for s, _ in trace.kernel_table(device).values())
    assert old > 3 * window_s
    # A card the run asked for that ran nothing counts as idle.
    assert trace.busy_seconds(device, 5) == pytest.approx(busy * 4 / 5)


def test_one_card_reads_as_before():
    """On one card the busy time is the old sum of every event's own time,
    bit for bit, and the memory peak is card 0's."""
    device = [("a", 0.0, 3.0, 3.0, 0), ("b", 3.0, 5.125, 2.125, 0),
              ("a", 6.0, 7.1, 1.1, 0), ("c", 7.5, 9.0, 1.5, 0)]
    old = sum(s for s, _ in trace.kernel_table(device).values())
    assert trace.busy_seconds(device, 1) == old
    asked = []
    assert trace.memory_peak(1, lambda card: asked.append(card) or 42) == 42
    assert asked == [0]
    peaks = {0: 5, 1: 9, 2: 7, 3: 1}
    assert trace.memory_peak(4, peaks.get) == 9


def test_a_split_traffic_names_its_cards_in_place_of_device(fresh_home):
    """A traffic whose calls split the spins over cards (``devices``) runs
    through the harness correct, the program given no ``device`` beside
    them; any other traffic's calls name the run's device."""
    seen = []

    def program(sim, *args, **kwargs):
        seen.append(kwargs)
        return sim(*args, **kwargs)

    split = {"quiet": True, "final_pos": True, "devices": ["cpu", "cpu"]}
    traffic = dict(TINY["traffic"], simulation=split)
    result = run.run("cylinder.classic-f64", 2**31 + 41, 0.1, False,
                     device="cpu", overrides={"traffic": traffic},
                     program=program)
    assert result["correct"] is True and seen
    assert all(k["devices"] == ["cpu", "cpu"] and "device" not in k
               for k in seen)
    plain = {"simulation": {"quiet": True}, "dtype": "float32"}
    assert run.call_kwargs(plain, 5, "cuda") == {
        "quiet": True, "seed": 5, "dtype": "float32", "device": "cuda"}
