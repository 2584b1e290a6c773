"""repro_torch.obs -- tracing, metrics and rate accounting (the JAX
package's ``repro.obs``, with the same public names).

Two layers with different gating:

* **Carrier metrics** (``obs.counter/gauge/histogram/child_counter``)
  are always live.  One ``obs.snapshot()`` exports everything.
* **Ambient instrumentation** (``obs.span``, ``obs.count``,
  ``obs.observe``, ``obs.gauge_set``, trace counter/instant events,
  ``obs.device_sync``) is gated on ``REPRO_OBS`` (or ``obs.enable()``):
  disabled, ``span`` returns one shared no-op singleton and the record
  helpers fall through a single boolean test, so the hot path adds no
  device synchronize.

Tracing exports Chrome trace events (``obs.export_trace(path)``,
loadable in Perfetto); ``obs.stage_durations(prefix)`` aggregates span
wall times; ``obs.run_report(container)`` breaks a container (monolithic
or tiled) into bytes per section kind and achieved-vs-Shannon bits.
Instrumentation is strictly observational: container bytes are
identical with observability on and off.
"""
from __future__ import annotations

import os as _os

import torch as _torch

from . import metrics as _metrics
from . import trace as _trace
from .metrics import REGISTRY

__all__ = [
    "enabled", "enable", "disable",
    "counter", "gauge", "histogram", "child_counter",
    "count", "gauge_set", "observe",
    "span", "counter_event", "instant_event", "name_thread",
    "device_sync", "snapshot", "export_trace", "trace_events",
    "reset", "run_report", "stage_durations", "REGISTRY",
]

_enabled = _os.environ.get("REPRO_OBS", "0").strip() not in ("", "0")

# Every finished span also lands its duration in a "span.<name>"
# Histogram, so per-stage wall time is queryable from the metrics
# snapshot (stage_durations), not just the bounded trace buffer.
_trace.set_exit_hook(
    lambda name, dur_ns: REGISTRY.histogram("span." + name).observe(dur_ns))


def enabled() -> bool:
    return _enabled


def enable():
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


# -- carrier metrics (always live) -------------------------------------

def counter(name: str) -> _metrics.Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> _metrics.Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str) -> _metrics.Histogram:
    return REGISTRY.histogram(name)


def child_counter(name: str) -> _metrics.Counter:
    return REGISTRY.child_counter(name)


def snapshot() -> dict:
    return REGISTRY.snapshot()


# -- ambient instrumentation (REPRO_OBS-gated) -------------------------

def count(name: str, n: int = 1):
    if _enabled:
        REGISTRY.counter(name).add(n)


def gauge_set(name: str, v):
    if _enabled:
        REGISTRY.gauge(name).set(v)


def observe(name: str, v):
    if _enabled:
        REGISTRY.histogram(name).observe(v)


def span(name: str, **args):
    if not _enabled:
        return _trace.NOOP
    return _trace.Span(name, args)


def counter_event(name: str, **values):
    if _enabled:
        _trace.counter_event(name, **values)


def instant_event(name: str, **values):
    if _enabled:
        _trace.instant_event(name, **values)


def name_thread(label: str):
    if _enabled:
        _trace.name_thread(label)


def device_sync(x):
    """Wait for the device work queued before this call -- ONLY when
    tracing is on and ``x`` is a CUDA tensor, so a span measures the
    device time of its own stage instead of billing queued launches to
    whoever syncs next.  A failing synchronize raises.  Value-neutral:
    returns ``x`` unchanged either way."""
    if _enabled and isinstance(x, _torch.Tensor) and x.is_cuda:
        _torch.cuda.synchronize(x.device)
    return x


def stage_durations(prefix: str = "") -> dict:
    """Per-span-name duration aggregates from the ``span.*`` Histograms:
    ``{span_name: {"count", "sum_s", "min_s", "max_s"}}`` for every span
    whose name starts with ``prefix`` ("" = all)."""
    out = {}
    for name, snap in REGISTRY.snapshot().items():
        if not name.startswith("span."):
            continue
        stage = name[len("span."):]
        if not stage.startswith(prefix):
            continue
        if snap.get("type") != "histogram" or not snap.get("count"):
            continue
        out[stage] = {
            "count": snap["count"],
            "sum_s": snap["sum"] / 1e9,
            "min_s": (snap["min"] or 0) / 1e9,
            "max_s": (snap["max"] or 0) / 1e9,
        }
    return out


def export_trace(path: str) -> int:
    return _trace.export(path)


def trace_events() -> list:
    return _trace.events()


def reset():
    """Clear metrics and the trace buffer (tests, bench arms)."""
    REGISTRY.reset()
    _trace.reset()


def run_report(container: bytes) -> dict:
    from .report import run_report as _rr

    return _rr(container)
