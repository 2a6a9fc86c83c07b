"""The rate, the tail, the roofline and the trace arithmetic on synthetic
inputs."""

import importlib
import types

import numpy as np
import pytest

from harness import manifest, roofline, stats, trace


def _metric(name):
    return manifest.metric_reader(name)


def test_rate_is_all_the_work_over_all_the_window():
    ctx = types.SimpleNamespace(n_walkers=1000, n_t=10,
                                calls=[(1, 0.5, None)] * 7, window_s=4.0)
    assert _metric("spin_steps_per_s").read(ctx) == pytest.approx(
        7 * 1000 * 10 / 4.0)


def test_p95_of_call_times():
    walls = [0.1] * 95 + [1.0] * 5
    ctx = types.SimpleNamespace(calls=[(k, w, None) for k, w in
                                       enumerate(walls)])
    expected = np.percentile(walls, 95) * 1e3
    assert _metric("call_p95_ms").read(ctx) == pytest.approx(expected)
    assert stats.percentile([1, 2, 3, 4], 50) == 2.5


def test_least_time_is_the_larger_bound():
    t, by = roofline.least_seconds(3.35e12, 0.0, "float64")
    assert (t, by) == (pytest.approx(1.0), "bytes")
    t, by = roofline.least_seconds(0.0, 67e12, "float32")
    assert (t, by) == (pytest.approx(1.0), "operations")
    assert roofline.share(0.5, 2.0) == pytest.approx(25.0)
    assert roofline.share(0.5, 0.0) is None


def test_mesh_step_least_time_sums_its_steps():
    mod = _metric("mesh_step_roofline")
    tests, records = [1e9, 0], [0, 1e6]
    n = 1000
    got = mod.least_call_seconds(tests, records, n, "float64")
    first = max(8 * 9 * n / 3.35e12, 1e9 * 52 / 34e12)
    second = max(8 * (9 * n + 12e6) / 3.35e12, 0.0)
    assert got == pytest.approx(first + second)


def test_k1_roofline_from_counts():
    mod = _metric("k1_roofline")
    ctx = types.SimpleNamespace(
        kernels={"void fused_epoch_kernel<false>(EpochParams)": (0.02, 10),
                 "void directions_kernel(int)": (0.001, 10)},
        calls=[None] * 2, n_walkers=1000, k1_units=1_000_000, k1_J=4,
        k1_table_bytes=1e6)
    flops = 1e6 * 64 * 40
    n_bytes = 5 * (1e6 + 1000 * (4 * 18 + 16 + 64 + 1))
    least = max(flops / 67e12, n_bytes / 3.35e12)
    assert mod.read(ctx) == pytest.approx(100 * least / 0.01)
    ctx.kernels = {"void directions_kernel(int)": (0.001, 10)}
    assert mod.read(ctx) is None


def test_glue_and_device_metrics():
    kernels = {"void fused_epoch_kernel<false>(EpochParams)": (0.06, 8),
               "void directions_kernel(int)": (0.002, 8),
               "Memcpy DtoD (Device -> Device)": (0.01, 40),
               "void at::native::sort(...)": (0.008, 16)}
    ctx = types.SimpleNamespace(kernels=kernels, calls=[None] * 2,
                                busy_s=0.08, window_s=0.1, events=72)
    assert _metric("fused_glue_ms").read(ctx) == pytest.approx(9.0)
    assert _metric("classic_glue_ms").read(ctx) is None
    assert _metric("device_idle").read(ctx) == pytest.approx(20.0)
    assert _metric("device_events").read(ctx) == pytest.approx(36.0)


def test_signal_gap():
    a = np.array([10.0, 5.0, 1.0])
    assert stats.signal_gap(a, a + [0, 0.5, -1.0], 100) == pytest.approx(
        0.01)
    assert stats.signal_gap(a * np.nan, a, 100) == float("inf")
    assert stats.signal_gap(a[:2], a, 100) == float("inf")


def test_kernel_ids():
    assert trace.kernel_id("void hit_pass<double>(MeshArgs, int)") == \
        "hit_pass"
    assert trace.kernel_id(
        "void (anonymous namespace)::stencil_pass<double, true>(double "
        "const*, int)") == "stencil_pass"
    assert trace.kernel_id("(anonymous namespace)::scan_pass(int const*, "
                           "int, int*)") == "scan_pass"
    assert trace.kernel_id("void at_cuda_detail::cub::DeviceRadixSortOnes"
                           "weepKernel<at_cuda_detail::cub::X>(int)") == \
        "DeviceRadixSortOnesweepKernel"
    assert trace.kernel_id("fused_epoch_kernel(EpochParams)") == \
        "fused_epoch_kernel"
    assert trace.kernel_id("Memcpy HtoD (Pageable -> Device)") == \
        "Memcpy HtoD (Pageable -> Device)"


def test_idle_gaps_are_labelled_by_the_host():
    device = [("k", 0.0, 10.0, 10.0), ("k", 30.0, 35.0, 5.0),
              ("k", 36.0, 40.0, 4.0)]
    host = [("portbench.window", -5.0, 50.0), ("cudaGraphLaunch", 12.0, 29.0),
            ("aten::copy_", 21.0, 22.0)]
    gaps = trace.idle_gaps(device, host, -5.0, 50.0)
    assert gaps[0] == ("cudaGraphLaunch", pytest.approx(20e-6))
    assert [round(s * 1e6) for _, s in gaps] == [20, 10, 5, 1]
    assert gaps[1][0] == "portbench.window"
    table = trace.kernel_table(device)
    assert table == {"k": (pytest.approx(19e-6), 3)}
    out = trace.breakdown(table, gaps)
    assert out["device_ops"] == [["k", pytest.approx(19e-6)]]
    assert len(out["idle_gaps"]) == 4


def test_waveform_matches_the_published_b_values():
    from harness import waveforms

    traffic = manifest.read_json("traffic", "fused.json")
    g = waveforms.make(traffic)
    assert g.shape == (100, 1000, 3)
    b = waveforms._b_values(g, traffic["dt"])
    assert np.allclose(b, np.linspace(1.0, 3e9, 100), rtol=1e-9)
    assert importlib.util.find_spec("harness.waveforms") is not None


@pytest.mark.parametrize("name", ["fused", "classic-f64"])
def test_waveform_is_a_spin_echo(name):
    """The lobes do not overlap, the gradient integrates to zero, and the
    second lobe starts 40 ms after the first (the published big delta)."""
    from harness import waveforms

    traffic = manifest.read_json("traffic", name + ".json")
    g = waveforms.make(traffic)[:, :, 0]
    dt = traffic["dt"]
    assert np.all(np.abs(g.sum(axis=1)) * dt
                  <= 1e-12 * np.abs(g).sum(axis=1) * dt)
    up, down = np.nonzero(g[-1] > 0)[0], np.nonzero(g[-1] < 0)[0]
    assert up[-1] < down[0]
    delta, big_delta = (up[-1] - up[0]) * dt, (down[0] - up[0]) * dt
    assert delta <= big_delta
    assert big_delta == pytest.approx(40e-3, abs=2 * dt)
    assert delta == pytest.approx(30e-3, abs=2 * dt)


def test_overlapping_lobes_are_refused():
    from harness import waveforms

    with pytest.raises(ValueError):
        waveforms.lobes(100, 51, 0, 100, 1e-4, [1e9])
