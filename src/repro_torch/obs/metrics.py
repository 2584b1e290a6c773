"""Process-wide metrics registry (the JAX package's
``repro.obs.metrics``, which has no JAX in it, copied).

Three metric kinds, all thread-safe with a record path that is one
lock acquire + one integer op:

* ``Counter`` -- monotonically increasing int.  A counter can be a
  *child* of a registered parent: the child keeps a private value (the
  backing store for public per-object fields like
  ``ContainerSource.reads``) while every ``add`` also flows into the
  registry-wide parent, so one ``snapshot()`` sees process totals and
  per-object views stay exact.
* ``Gauge`` -- last-write-wins scalar (queue depths, cache bytes).
* ``Histogram`` -- fixed log2 buckets over non-negative integer
  observations (nanoseconds, bytes).  Bucket 0 counts exact zeros;
  bucket ``i >= 1`` counts values in ``[2^(i-1), 2^i)``; the last
  bucket (index 63) absorbs everything ``>= 2^62``.  Fixed buckets
  mean ``observe`` never allocates and two process snapshots are
  always mergeable.

Metrics are ALWAYS live (they are the storage behind pre-existing
public counters, whose values existing tests pin regardless of
``REPRO_OBS``); only the ambient instrumentation helpers in
``repro_torch.obs`` -- spans, trace counter events, ``obs.count`` et al. --
are env-gated.
"""
from __future__ import annotations

import threading

N_BUCKETS = 64


class Counter:
    __slots__ = ("name", "_lock", "_n", "_parent")

    def __init__(self, name: str, parent: "Counter | None" = None):
        self.name = name
        self._lock = threading.Lock()
        self._n = 0
        self._parent = parent

    def add(self, n: int = 1):
        with self._lock:
            self._n += n
        if self._parent is not None:
            self._parent.add(n)

    @property
    def value(self) -> int:
        return self._n

    def set_local(self, v: int):
        """Overwrite the private value WITHOUT touching the parent --
        for checkpoint/restore of objects whose public counter is a
        child view (the parent keeps counting this-process work)."""
        with self._lock:
            self._n = int(v)

    def snapshot(self):
        return {"type": "counter", "value": self._n}


class Gauge:
    __slots__ = ("name", "_lock", "_v")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._v = 0

    def set(self, v):
        with self._lock:
            self._v = v

    def add(self, n=1):
        with self._lock:
            self._v += n

    @property
    def value(self):
        return self._v

    def snapshot(self):
        return {"type": "gauge", "value": self._v}


class Histogram:
    __slots__ = ("name", "_lock", "_buckets", "_count", "_sum",
                 "_min", "_max")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._buckets = [0] * N_BUCKETS
        self._count = 0
        self._sum = 0
        self._min = None
        self._max = None

    def observe(self, v):
        iv = int(v)
        if iv < 0:
            iv = 0
        idx = iv.bit_length()
        if idx >= N_BUCKETS:
            idx = N_BUCKETS - 1
        with self._lock:
            self._buckets[idx] += 1
            self._count += 1
            self._sum += iv
            if self._min is None or iv < self._min:
                self._min = iv
            if self._max is None or iv > self._max:
                self._max = iv

    @property
    def count(self):
        return self._count

    def snapshot(self):
        with self._lock:
            buckets = {i: c for i, c in enumerate(self._buckets) if c}
            return {
                "type": "histogram",
                "count": self._count,
                "sum": self._sum,
                "min": self._min,
                "max": self._max,
                "buckets": buckets,
            }


class Registry:
    """Name -> metric map.  Creation takes the registry lock once;
    recording touches only the metric's own lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}

    def _get(self, name, cls):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = cls(name)
                    self._metrics[name] = m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, requested {cls.__name__}")
        return m

    def counter(self, name) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name) -> Histogram:
        return self._get(name, Histogram)

    def child_counter(self, name) -> Counter:
        """A private counter whose adds also roll up into the
        registered process-wide counter ``name``."""
        return Counter(name, parent=self.counter(name))

    def snapshot(self):
        with self._lock:
            items = list(self._metrics.items())
        return {name: m.snapshot() for name, m in sorted(items)}

    def reset(self):
        with self._lock:
            self._metrics.clear()


REGISTRY = Registry()
