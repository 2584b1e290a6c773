"""The traced window: ``torch.profiler`` over the window, reduced to the
device's busy time, the device operations that took most time, and the
longest idle gaps by the program's span that the host was in.

The device's busy time is the union of its kernels' and copies'
intervals inside the window, a card at a time, averaged over the cards.
A gap is an interval of the window in which no card ran anything; it is
named after the innermost span of ``repro_torch.obs`` (or of the
benchmark's own, ``bench.*``) open at its middle.  The profiler's and
the spans' clocks are tied by one span opened with the window's
``record_function``.
"""
from __future__ import annotations

import heapq
from collections import defaultdict

TOP = 10
# gaps shorter than this are launch spacing, not host work
MIN_GAP_S = 20e-6
# device-side entries that are no work: the profiler's own buffer, and
# the device-side copy of a ``record_function`` range (the window's own)
NOT_WORK = ("Activity Buffer Request",)
LABEL_PREFIX = "bench."


class Profile:
    def __init__(self, on_card: bool):
        self.on_card = on_card
        self._prof = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        from repro_torch import obs

        acts = [ProfilerActivity.CPU]
        if self.on_card:
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._rf = record_function("bench.window")
        self._rf.__enter__()
        self._span = obs.span("bench.window")
        self._span.__enter__()

    def stop(self) -> dict:
        import torch

        from repro_torch import obs

        if self.on_card:
            torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self._rf.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        return reduce(_intervals(self._prof), obs.trace_events())


def _intervals(prof):
    """(name, on the device, device index, start, end) in microseconds of
    every profiled event, read from the profiler's raw results: its
    ``events()`` builds a Python object a host op, which takes minutes
    over a window of tiled compresses."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == DeviceType.CUDA
        yield (e.name(), on_device, e.device_index(), e.start_ns() / 1e3,
               e.end_ns() / 1e3)


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _clip(intervals, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def reduce(events, span_events) -> dict:
    """Profiled events (``_intervals``) and the obs trace's complete
    events -> busy_s, window_s, device_ops, idle_gaps and the device
    seconds and launches of each device operation by name."""
    window = None
    dev_iv = defaultdict(list)
    by_name = defaultdict(lambda: [0.0, 0])
    for name, on_device, index, start, end in events:
        if on_device:
            if name in NOT_WORK or name.startswith(LABEL_PREFIX):
                continue
            dev_iv[index].append((start, end))
            row = by_name[name]
            row[0] += (end - start) / 1e6
            row[1] += 1
        elif name == "bench.window" and window is None:
            window = (start, end)
    if window is None:
        return {"busy_s": 0.0, "window_s": 0.0, "device_ops": [],
                "idle_gaps": [], "ops": {}}
    lo, hi = window
    window_s = (hi - lo) / 1e6
    per_card = {d: _union(_clip(iv, lo, hi)) for d, iv in dev_iv.items()}
    busy = [sum(b - a for a, b in u) / 1e6 for u in per_card.values()]
    busy_s = sum(busy) / len(busy) if busy else 0.0
    ops = {n: (s, c) for n, (s, c) in by_name.items()}
    device_ops = sorted(([n[:160], s] for n, (s, _) in ops.items()),
                        key=lambda r: -r[1])[:TOP]
    return {"busy_s": busy_s, "window_s": window_s,
            "cards": len(per_card), "device_ops": device_ops,
            "idle_gaps": idle_gaps(per_card, lo, hi, span_events),
            "ops": ops}


def idle_gaps(per_card, lo, hi, span_events) -> list:
    """Seconds of the window in which no card ran anything, by the
    innermost span open at each gap's middle; the ``TOP`` largest."""
    busy = _union([iv for u in per_card.values() for iv in u])
    gaps, t = [], lo
    for a, b in busy:
        if a - t >= MIN_GAP_S * 1e6:
            gaps.append((t, a))
        t = max(t, b)
    if hi - t >= MIN_GAP_S * 1e6:
        gaps.append((t, hi))
    spans = [e for e in span_events if e.get("ph") == "X"]
    anchor = next((e for e in spans if e["name"] == "bench.window"), None)
    offset = lo - anchor["ts"] if anchor else 0.0
    spans = [(e["ts"] + offset, e["ts"] + offset + e["dur"], e["name"])
             for e in spans]
    spans.sort()
    total = defaultdict(float)
    open_, k = [], 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (a + b)
        while k < len(spans) and spans[k][0] <= mid:
            s, e, n = spans[k]
            heapq.heappush(open_, (e, s, n))
            k += 1
        while open_ and open_[0][0] < mid:
            heapq.heappop(open_)
        inner = min(((e - s, n) for e, s, n in open_ if e >= mid),
                    default=None)
        total[inner[1] if inner else "(no span)"] += (b - a) / 1e6
    return sorted(([n, s] for n, s in total.items()),
                  key=lambda r: -r[1])[:TOP]
