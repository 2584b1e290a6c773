"""repro_torch.obs: metrics registry, span tracing, disabled-path no-ops,
trace JSON schema, and the port's spans and rate accounting against the
JAX package's ``repro.obs`` (CPU).  Mirrors tests/test_obs.py in its
monolithic form; the async-engine and retry cases wait for the port of
streaming (ROADMAP Queue 1 item 8)."""
import pytest

pytest.importorskip("torch")

import collections
import json
import threading

import numpy as np
import torch

import repro.core as core
from repro import obs as r_obs
from repro.obs import trace as r_trace
from repro.core import TileGrid, compress_tiled
import repro_torch
from repro_torch import obs
from repro_torch.obs import metrics, trace

CFG = dict(eb=1e-2, mode="rel", predictor="mop", verify=True, fused=True)


@pytest.fixture
def obs_state():
    """Restore both packages' enabled flags and clear their trace
    buffers afterwards.  The metrics registries are NOT reset: carrier
    metrics are process-wide by design, so tests assert on deltas."""
    was, r_was = obs.enabled(), r_obs.enabled()
    yield
    (obs.enable if was else obs.disable)()
    (r_obs.enable if r_was else r_obs.disable)()
    trace.reset()
    r_trace.reset()


def _large_magnitude_field():
    # the verify-firing fixture of tests/test_backend_parity.py
    rng = np.random.default_rng(3)
    u = (1.0e8 + rng.normal(0, 100.0, (4, 16, 16))).astype(np.float32)
    v = (1.0e8 + rng.normal(0, 100.0, (4, 16, 16))).astype(np.float32)
    return u, v


# ----------------------------------------------------------------------
# metrics registry
# ----------------------------------------------------------------------

def test_histogram_log2_bucket_edges():
    h = metrics.Histogram("t")
    for x in (0, 1, 2, 3, 4, 7, -5, 2**62, 2**63 + 1):
        h.observe(x)
    snap = h.snapshot()
    assert snap["buckets"] == {0: 2, 1: 1, 2: 2, 3: 2, 63: 2}
    assert snap["count"] == 9
    assert snap["min"] == 0
    assert snap["max"] == 2**63 + 1
    for k in range(1, 20):
        hh = metrics.Histogram("e")
        hh.observe(2**k)
        hh.observe(2**k - 1)
        assert hh.snapshot()["buckets"] == {k + 1: 1, k: 1}


def test_registry_kind_mismatch_raises():
    r = metrics.Registry()
    r.counter("x")
    with pytest.raises(TypeError):
        r.gauge("x")


def test_child_counter_rollup_and_set_local():
    parent = obs.counter("test.obs.rollup")
    base = parent.value
    a = obs.child_counter("test.obs.rollup")
    b = obs.child_counter("test.obs.rollup")
    a.add(3)
    b.add(4)
    assert (a.value, b.value) == (3, 4)
    assert parent.value == base + 7
    a.set_local(0)
    assert a.value == 0
    assert parent.value == base + 7
    a.add(2)
    assert parent.value == base + 9


def test_snapshot_exact_under_concurrent_writers():
    n_threads, n_adds = 8, 2_000
    c = obs.counter("test.obs.concurrent")
    h = obs.histogram("test.obs.concurrent_h")
    base = c.value
    stop = threading.Event()
    snaps = []

    def writer():
        child = obs.child_counter("test.obs.concurrent")
        for i in range(n_adds):
            child.add(1)
            h.observe(i)

    def snapshotter():
        while not stop.is_set():
            snaps.append(obs.snapshot())

    ts = [threading.Thread(target=writer) for _ in range(n_threads)]
    sn = threading.Thread(target=snapshotter)
    sn.start()
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive()
    stop.set()
    sn.join(timeout=60)
    assert not sn.is_alive()
    seen = [s["test.obs.concurrent"]["value"] for s in snaps
            if "test.obs.concurrent" in s]
    assert all(x <= y for x, y in zip(seen, seen[1:]))
    final = obs.snapshot()
    assert final["test.obs.concurrent"]["value"] == \
        base + n_threads * n_adds
    hs = final["test.obs.concurrent_h"]
    assert hs["count"] >= n_threads * n_adds
    assert sum(hs["buckets"].values()) == hs["count"]


# ----------------------------------------------------------------------
# disabled path
# ----------------------------------------------------------------------

def test_disabled_mode_is_noop(obs_state):
    obs.disable()
    trace.reset()
    s1 = obs.span("a", x=1)
    s2 = obs.span("b")
    assert s1 is s2 is trace.NOOP
    with s1 as sp:
        assert sp.set(y=2) is sp
    assert sp.dur_ns == 0 and sp.dur_s == 0.0
    obs.count("test.obs.gated_counter_never", 5)
    obs.observe("test.obs.gated_hist_never", 5)
    obs.gauge_set("test.obs.gated_gauge_never", 5)
    obs.counter_event("qq", depth=1)
    obs.instant_event("ii")
    obs.name_thread("tt")
    assert obs.trace_events() == []
    snap = obs.snapshot()
    for name in ("test.obs.gated_counter_never",
                 "test.obs.gated_hist_never",
                 "test.obs.gated_gauge_never"):
        assert name not in snap
    # device_sync is value-neutral in both modes, and a no-op for a CPU
    # tensor, a numpy array or None
    x = torch.arange(3)
    a = np.arange(3)
    assert obs.device_sync(x) is x
    obs.enable()
    assert obs.device_sync(x) is x and obs.device_sync(a) is a
    assert obs.device_sync(None) is None


def test_public_names_match_reference():
    assert obs.__all__ == r_obs.__all__
    for name in obs.__all__:
        assert hasattr(obs, name), name


# ----------------------------------------------------------------------
# span tracing
# ----------------------------------------------------------------------

def test_span_nesting_and_attributes(obs_state):
    obs.enable()
    trace.reset()
    with obs.span("outer", a=1) as so:
        assert trace.current_span() is so
        with obs.span("inner") as si:
            assert trace.current_span() is si
            si.set(found=7)
        assert trace.current_span() is so
    assert trace.current_span() is None
    evs = {e["name"]: e for e in obs.trace_events()}
    outer, inner = evs["outer"], evs["inner"]
    assert outer["args"] == {"a": 1}
    assert inner["args"] == {"found": 7}
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    assert "stack_corrupt" not in outer["args"]

    with pytest.raises(RuntimeError):
        with obs.span("failing"):
            raise RuntimeError("boom")
    fail = [e for e in obs.trace_events() if e["name"] == "failing"][0]
    assert fail["args"]["error"] == "RuntimeError"


def test_trace_json_schema_golden(obs_state, tmp_path):
    obs.enable()
    trace.reset()
    obs.name_thread("golden-thread")
    with obs.span("golden.work", unit=3):
        obs.counter_event("golden.queue", depth=2, backlog=0)
        obs.instant_event("golden.marker", why="test")
    path = tmp_path / "trace.json"
    assert obs.export_trace(str(path)) == 4
    payload = json.loads(path.read_text())
    assert set(payload) == {"traceEvents", "displayTimeUnit"}
    assert payload["displayTimeUnit"] == "ms"
    evs = payload["traceEvents"]
    assert sorted(e["ph"] for e in evs) == ["C", "M", "X", "i"]
    by_ph = {e["ph"]: e for e in evs}
    x = by_ph["X"]
    assert x["name"] == "golden.work" and x["args"] == {"unit": 3}
    assert isinstance(x["ts"], float) and isinstance(x["dur"], float)
    assert x["dur"] >= 0 and x["pid"] > 0 and x["tid"] > 0
    assert by_ph["C"]["args"] == {"depth": 2, "backlog": 0}
    assert by_ph["i"]["s"] == "t" and by_ph["i"]["args"] == {"why": "test"}
    assert by_ph["M"]["args"] == {"name": "golden-thread"}
    tss = [e.get("ts", 0.0) for e in evs]
    assert tss == sorted(tss)


# ----------------------------------------------------------------------
# the port's spans and rate accounting against the reference
# ----------------------------------------------------------------------

def _span_counts(mod):
    """{span name: count} of the calling thread's trace events.  A span
    that another thread records meanwhile (the stream writer of an
    earlier test, woken from a stall) is not the compress's under
    test."""
    me = threading.get_ident()
    return dict(collections.Counter(
        e["name"] for e in mod.trace_events()
        if e["ph"] == "X" and e["tid"] == me))


def _delta(after, before):
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


def _rounds_counter(mod):
    snap = mod.snapshot().get("pipeline.verify_rounds")
    return snap["value"] if snap else 0


@pytest.mark.parametrize("codec", ["host", "device"])
def test_spans_and_rounds_match_reference(obs_state, codec):
    """The same compress records the same span names and counts and the
    same ``pipeline.verify_rounds`` in both packages."""
    u, v = _large_magnitude_field()
    kw = dict(eb=6.0, mode="abs", codec=codec)
    obs.enable()
    r_obs.enable()
    trace.reset()
    r_trace.reset()
    got, want = {}, {}
    for mod, run, out in (
            (obs, lambda: repro_torch.compress(
                u, v, repro_torch.CompressionConfig(**kw), device="cpu"),
             got),
            (r_obs, lambda: core.compress(
                u, v, core.CompressionConfig(backend="numpy", **kw)),
             want)):
        spans0, rounds0 = _span_counts(mod), _rounds_counter(mod)
        _, st = run()
        out["spans"] = _delta(_span_counts(mod), spans0)
        out["rounds"] = _rounds_counter(mod) - rounds0
        out["n_bad"] = [e["args"]["n_bad"] for e in mod.trace_events()
                        if e["name"] == "pipeline.verify_round"
                        and e["tid"] == threading.get_ident()]
        assert out["n_bad"] == st["verify_bad_counts"]
    assert got == want
    assert got["rounds"] >= 1
    assert got["spans"]["pipeline.verify_round"] == got["rounds"] + 1
    assert ("entropy.encode_streams" in got["spans"]) == (codec == "device")


@pytest.mark.parametrize("codec", ["host", "device"])
def test_byte_identity_and_run_report(small_field, obs_state, codec):
    u, v = small_field
    cfg = repro_torch.CompressionConfig(codec=codec, **CFG)
    obs.disable()
    blob_off, _ = repro_torch.compress(u, v, cfg, device="cpu")
    obs.enable()
    blob_on, _ = repro_torch.compress(u, v, cfg, device="cpu")
    assert blob_off == blob_on, "observability changed the container bytes"
    rep = obs.run_report(blob_on)
    assert rep["container_bytes"] == len(blob_on)
    assert rep["kind_bytes_total"] == len(blob_on)
    assert sum(rep["bytes_by_kind"].values()) == len(blob_on)
    assert rep["n_units"] == len(rep["units"]) == 1
    assert all(r["n_symbols"] > 0 for r in rep["units"])
    # the same report as the JAX package's on the same container
    assert rep == r_obs.run_report(blob_on)


def test_run_report_tiled_not_ported(small_field):
    """Tiled containers were refused before the port of tiling; now the
    report of the JAX package's CPTT1 container is its own report."""
    u, v = small_field
    blob, _ = compress_tiled(u, v, core.CompressionConfig(
        backend="numpy", track_index=False, **CFG),
        TileGrid(tile_h=10, tile_w=14, window_t=3))
    rep = obs.run_report(blob)
    assert rep["kind_bytes_total"] == len(blob)
    assert rep == r_obs.run_report(blob)
