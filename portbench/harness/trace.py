"""The traced window: torch.profiler over a few calls, reduced to a kernel
table, the device's busy time, its idle gaps and the breakdown line.

The reduction is a copy of the busy-share arithmetic the port's smoke test
uses: a card's busy time sums its device events' own times (one stream a
card, so its events do not overlap); kernels are summed by name over every
card. Each event keeps the index of the card it ran on, so the busy time of
a run over several cards is the mean of the cards' own: cards busy at the
same time never add up to more than the window.
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


def synchronize(cards):
    """Wait for each of the first ``cards`` cards."""
    for card in range(cards):
        torch.cuda.synchronize(card)


def traced(run_calls, cards=1):
    """Run ``run_calls()`` under the profiler, the window closing once each
    of the first ``cards`` cards has finished. Returns (device events as
    (name, start_us, end_us, self_us, card), host events as (name,
    start_us, end_us), wall seconds)."""
    from torch.profiler import ProfilerActivity, profile

    synchronize(cards)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        run_calls()
        synchronize(cards)
        wall = time.perf_counter() - t0
    device, host = [], []
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end)
        if e.device_type.name == "CUDA":
            if (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(SPAN_PREFIX)):
                continue
            device.append((e.name, *span, e.self_device_time_total,
                           e.device_index))
        elif e.device_type.name == "CPU":
            host.append((e.name, *span))
    return device, host, wall


def kernel_table(device):
    """{name: (seconds, count)} of the device events, over every card."""
    table = {}
    for name, _, _, self_us, *_ in device:
        s, c = table.get(name, (0.0, 0))
        table[name] = (s + self_us * 1e-6, c + 1)
    return table


def card_busy(device, cards):
    """Each of the run's first ``cards`` cards' busy seconds: the summed
    own time of its events (events as ``traced`` gives them)."""
    out = []
    for card in range(cards):
        table = kernel_table([e for e in device if e[4] == card])
        out.append(sum(s for s, _ in table.values()))
    return out


def busy_seconds(device, cards):
    """The device's busy seconds: the cards' own, averaged over the run's
    ``cards`` cards, so a card with no event counts as idle."""
    return sum(card_busy(device, cards)) / cards


def memory_peak(cards, read=torch.cuda.max_memory_allocated):
    """The peak bytes allocated on the fullest of the first ``cards``
    cards, each read by ``read(card)``."""
    return max(read(card) for card in range(cards))


def idle_gaps(device, host, first=None, last=None):
    """Idle gaps between device events, longest first, as (label, seconds):
    each labelled with the innermost host event running at its middle
    (``host: no operator`` when none). ``first`` and ``last`` (us) bound
    the window: the gap before the first event and after the last count."""
    spans = sorted((e[1], e[2]) for e in device)
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
