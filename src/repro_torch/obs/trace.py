"""Span tracing with a Chrome-trace-event JSON exporter (the JAX
package's ``repro.obs.trace``, which has no JAX in it, copied).

Spans are complete events (``"ph": "X"``) stamped with the recording
thread's id, so spans of different threads land on their own tracks
in Perfetto and nest correctly per track by construction.  A thread-local
stack enforces LIFO discipline (enter/exit pairs can never interleave
across threads because the stack itself is per-thread); exiting a span
that is not the top of its own thread's stack is recorded as a
``stack_corrupt`` attribute instead of raising -- tracing must never
take down the pipeline.

Queue depths and other sampled series are counter events
(``"ph": "C"``); threads self-label with metadata events
(``"ph": "M"``/``thread_name``).  Timestamps are microseconds since an
import-time ``perf_counter_ns`` anchor, the unit Perfetto expects;
``zero_unix_us()`` places that anchor in Unix time, the axis
``torch.profiler`` stamps its host and device events on.

The buffer is bounded (``MAX_EVENTS``); overflow drops new events and
counts the drops, so a runaway trace degrades to missing tail data
rather than unbounded memory.
"""
from __future__ import annotations

import json
import os
import threading
import time

MAX_EVENTS = 500_000

_T0 = time.perf_counter_ns()
_LOCK = threading.Lock()
_EVENTS: list = []
_DROPPED = 0
_TLS = threading.local()

# span-exit observer installed by repro_torch.obs: every finished span
# also lands its duration in a metrics Histogram ("span.<name>"), which
# is what obs.stage_durations reads.  A plain module global (not
# thread-local): the hook itself is expected to be thread-safe, and
# instrumentation must never raise.
_EXIT_HOOK = None


def set_exit_hook(fn):
    """``fn(name, dur_ns)`` called after every Span exit (or None)."""
    global _EXIT_HOOK
    _EXIT_HOOK = fn


def _stack():
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def _emit(ev):
    global _DROPPED
    with _LOCK:
        if len(_EVENTS) < MAX_EVENTS:
            _EVENTS.append(ev)
        else:
            _DROPPED += 1


class Span:
    """``with Span("tiling.encode", {"unit": k}): ...`` -- records one
    complete event on exit.  ``set(**kw)`` adds attributes mid-span;
    ``dur_s``/``dur_ns`` are readable after exit (benchmarks derive
    their section timings from these instead of hand-rolled
    ``perf_counter`` pairs)."""

    __slots__ = ("name", "args", "_t0", "dur_ns")

    def __init__(self, name: str, args: dict | None = None):
        self.name = name
        self.args = dict(args) if args else {}
        self._t0 = 0
        self.dur_ns = 0

    def set(self, **kw):
        self.args.update(kw)
        return self

    def __enter__(self):
        _stack().append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        self.dur_ns = t1 - self._t0
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        else:  # never raise from instrumentation; flag for the tests
            self.args["stack_corrupt"] = True
            if self in st:
                st.remove(self)
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        _emit({
            "name": self.name,
            "ph": "X",
            "ts": (self._t0 - _T0) / 1e3,
            "dur": self.dur_ns / 1e3,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "args": self.args,
        })
        if _EXIT_HOOK is not None:
            try:
                _EXIT_HOOK(self.name, self.dur_ns)
            except Exception:
                pass  # instrumentation must never take down the pipeline
        return False

    @property
    def dur_s(self) -> float:
        return self.dur_ns / 1e9


class NoopSpan:
    """Shared disabled-path singleton: enter/exit/set are empty
    methods on an attribute-less instance -- the whole cost of a
    disabled ``with obs.span(...)`` is two no-op calls."""

    __slots__ = ()
    dur_ns = 0
    dur_s = 0.0

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **kw):
        return self


NOOP = NoopSpan()


def zero_unix_us() -> float:
    """Unix time, in microseconds, of the trace's zero: an event's
    ``ts`` plus this is its start on ``torch.profiler``'s axis.  Both
    clocks are read at the call, so a step of the wall clock since
    import does not carry into it."""
    a = time.perf_counter_ns()
    wall = time.time_ns()
    b = time.perf_counter_ns()
    return (wall - ((a + b) // 2 - _T0)) / 1e3


def current_span():
    st = _stack()
    return st[-1] if st else None


def counter_event(name: str, **values):
    """Sampled series (queue depth, cache bytes) as a Chrome counter
    event; each keyword becomes one series under the counter track."""
    _emit({
        "name": name,
        "ph": "C",
        "ts": (time.perf_counter_ns() - _T0) / 1e3,
        "pid": os.getpid(),
        "tid": threading.get_ident(),
        "args": values,
    })


def instant_event(name: str, **values):
    """Point-in-time marker (watchdog fire, resume, retry)."""
    _emit({
        "name": name,
        "ph": "i",
        "s": "t",
        "ts": (time.perf_counter_ns() - _T0) / 1e3,
        "pid": os.getpid(),
        "tid": threading.get_ident(),
        "args": values,
    })


def name_thread(label: str):
    _emit({
        "name": "thread_name",
        "ph": "M",
        "pid": os.getpid(),
        "tid": threading.get_ident(),
        "args": {"name": label},
    })


def events():
    with _LOCK:
        return list(_EVENTS)


def dropped() -> int:
    return _DROPPED


def export(path: str) -> int:
    """Write the buffered events as a Chrome trace JSON object
    (loadable in Perfetto / chrome://tracing).  Returns the number of
    events written."""
    with _LOCK:
        evs = list(_EVENTS)
    evs.sort(key=lambda e: e.get("ts", 0.0))
    payload = {"traceEvents": evs, "displayTimeUnit": "ms"}
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)
    return len(evs)


def reset():
    global _DROPPED
    with _LOCK:
        _EVENTS.clear()
        _DROPPED = 0
