"""The traced window: torch.profiler over a few calls, reduced to a kernel
table, the device's busy time, its idle gaps and the breakdown line.

The reduction is a copy of the busy-share arithmetic the port's smoke test
uses: busy time sums each device event's own time (one stream, so the
events do not overlap); kernels are summed by name.
"""

import re
import time

import torch

_IDENT = re.compile(r"(?:[A-Za-z_]\w*::)*([A-Za-z_]\w*)\s*[<(]")
# Spans the harness opens around its calls: on the device's timeline they
# are annotations, not operations.
SPAN_PREFIX = "portbench."


def kernel_id(name):
    """The function name inside a device event's name (``void (anonymous
    namespace)::hit_pass<double, true>(...)`` -> ``hit_pass``); other
    events keep their name."""
    head = name[5:] if name.startswith("void ") else name
    m = _IDENT.match(head.replace("(anonymous namespace)::", ""))
    return m.group(1) if m else name


def traced(run_calls):
    """Run ``run_calls()`` under the profiler. Returns (device events as
    (name, start_us, end_us, self_us), host events as (name, start_us,
    end_us), wall seconds)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        run_calls()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device, host = [], []
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end)
        if e.device_type.name == "CUDA":
            if (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(SPAN_PREFIX)):
                continue
            device.append((e.name, *span, e.self_device_time_total))
        elif e.device_type.name == "CPU":
            host.append((e.name, *span))
    return device, host, wall


def kernel_table(device):
    """{name: (seconds, count)} of the device events."""
    table = {}
    for name, _, _, self_us in device:
        s, c = table.get(name, (0.0, 0))
        table[name] = (s + self_us * 1e-6, c + 1)
    return table


def idle_gaps(device, host, first=None, last=None):
    """Idle gaps between device events, longest first, as (label, seconds):
    each labelled with the innermost host event running at its middle
    (``host: no operator`` when none). ``first`` and ``last`` (us) bound
    the window: the gap before the first event and after the last count."""
    spans = sorted((s, e) for _, s, e, _ in device)
    gaps = []
    end = first if first is not None else (spans[0][0] if spans else 0)
    for s, e in spans:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if last is not None and last > end:
        gaps.append((end, last))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:10]:
        mid = 0.5 * (a + b)
        covering = [(e - s, name) for name, s, e in host if s <= mid <= e]
        label = min(covering)[1] if covering else "host: no operator"
        out.append((label[:80], (b - a) * 1e-6))
    return out


def breakdown(table, gaps):
    """The result line's breakdown: the ten device operations with the most
    time and the ten longest idle gaps."""
    ops = sorted(table.items(), key=lambda kv: -kv[1][0])[:10]
    return {"device_ops": [[kernel_id(k)[:80], s] for k, (s, _) in ops],
            "idle_gaps": [[label, s] for label, s in gaps]}
