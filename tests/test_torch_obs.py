"""repro_torch.obs: metrics registry, span tracing, disabled-path no-ops,
trace JSON schema, and the port's spans and rate accounting against the
JAX package's ``repro.obs`` (CPU).  Mirrors tests/test_obs.py in its
monolithic form; the async-engine and retry cases wait for the port of
streaming (ROADMAP Queue 1 item 8)."""
import pytest

pytest.importorskip("torch")

import collections
import json
import struct
import threading
import time

import numpy as np
import torch

import repro.core as core
from repro import obs as r_obs
from repro.obs import trace as r_trace
from repro.core import TileGrid, compress_tiled
import repro_torch
from repro_torch import obs
from repro_torch.core import _msgpack, encode
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


def _port_only_spans(spans):
    """The spans of a port's monolithic MoP compress that the reference
    does not record: the host set-up, the uploads, the lossless mask's
    download and the MoP rate model, with their counts."""
    return {"compressor.prepare": 1, "pipeline.upload": 1,
            "pipeline.download": 1,
            "mop.select": spans["pipeline.quantize_predict"]}


@pytest.mark.parametrize("codec", ["host", "device"])
def test_spans_and_rounds_match_reference(obs_state, codec):
    """The same compress records every span of the reference with the
    same count and the same ``pipeline.verify_rounds`` in both packages;
    the port's other spans are exactly ``_port_only_spans``."""
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
    extra = {k: n for k, n in got["spans"].items() if k not in want["spans"]}
    assert extra == _port_only_spans(got["spans"])
    got["spans"] = {k: n for k, n in got["spans"].items() if k not in extra}
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


# ----------------------------------------------------------------------
# the port's own spans: host set-up and copies, mop.select, the decode
# ----------------------------------------------------------------------

# a small field whose MoP picks SL blocks, so decode.sl steps some
ADV = dict(eb=1e-2, mode="rel", predictor="mop", dt=0.05, dx=2.0 / 63,
           dy=1.0 / 47)


def _advective():
    from repro_torch.data import synthetic

    return synthetic.vortex_street(T=6, H=48, W=64)


def _my_spans():
    me = threading.get_ident()
    return [e for e in obs.trace_events() if e["ph"] == "X"
            and e["tid"] == me]


def _inside(inner, outer):
    return outer["ts"] <= inner["ts"] and \
        inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3


def _huffman_sections(blob):
    """Names of a CPTH1 container's Huffman-coded sections."""
    if blob[:len(encode.MAGIC_HUF)] != encode.MAGIC_HUF:
        return []
    m = len(encode.MAGIC_HUF)
    (hlen,) = struct.unpack("<I", blob[m: m + 4])
    header = _msgpack.unpackb(blob[m + 4: m + 4 + hlen])
    return [k for k, meta in header["sections"].items()
            if meta.get("enc") == "huff"]


@pytest.mark.parametrize("codec", ["host", "device"])
def test_write_spans_on_the_calling_thread(obs_state, codec):
    """A monolithic compress records the set-up, the uploads and the
    mask's download once each and ``mop.select`` once inside each
    ``pipeline.quantize_predict``, on the caller's thread; the uploads'
    span counts the host bytes copied."""
    u, v = _advective()
    obs.enable()
    trace.reset()
    repro_torch.compress(u, v, repro_torch.CompressionConfig(
        codec=codec, **ADV), device="cpu")
    evs = _my_spans()
    counts = collections.Counter(e["name"] for e in evs)
    assert {k: counts[k] for k in ("compressor.prepare", "pipeline.upload",
                                   "pipeline.download")} == \
        {"compressor.prepare": 1, "pipeline.upload": 1,
         "pipeline.download": 1}
    qp = [e for e in evs if e["name"] == "pipeline.quantize_predict"]
    sel = [e for e in evs if e["name"] == "mop.select"]
    assert len(sel) == len(qp) >= 1
    for s_, q in zip(sel, qp):
        assert _inside(s_, q)
        assert s_["args"]["tiles"] == 6 * 3 * 4      # T * nbi * nbj
    byname = {e["name"]: e for e in evs}
    assert byname["compressor.prepare"]["args"]["shape"] == [6, 48, 64]
    # ufp, vfp int64 and u, v float32
    assert byname["pipeline.upload"]["args"]["bytes"] == 2 * (8 + 4) * u.size
    assert byname["pipeline.download"]["args"]["bytes"] == u.size
    order = [e["name"] for e in sorted(evs, key=lambda e: e["ts"])
             if e["name"] in ("compressor.prepare", "pipeline.upload",
                              "pipeline.derive_eb", "pipeline.download",
                              "pipeline.symbolize")]
    assert order == ["compressor.prepare", "pipeline.upload",
                     "pipeline.derive_eb", "pipeline.download",
                     "pipeline.symbolize"]


@pytest.mark.parametrize("codec", ["host", "device"])
def test_decode_spans(obs_state, codec):
    """A monolithic decompress records the unpack, parse, SL decode and
    reconstruction once each, and one ``decode.huffman`` inside the
    unpack for each Huffman-coded section (device codec only)."""
    u, v = _advective()
    blob, _ = repro_torch.compress(u, v, repro_torch.CompressionConfig(
        codec=codec, **ADV), device="cpu")
    huff = _huffman_sections(blob)
    assert (len(huff) > 0) == (codec == "device")
    obs.enable()
    trace.reset()
    repro_torch.decompress(blob, device="cpu")
    evs = _my_spans()
    counts = collections.Counter(e["name"] for e in evs)
    assert dict(counts) == {"decode.unpack": 1, "decode.parse": 1,
                            "decode.sl": 1, "decode.reconstruct": 1,
                            **({"decode.huffman": len(huff)} if huff
                               else {})}
    unpack = next(e for e in evs if e["name"] == "decode.unpack")
    assert unpack["args"]["bytes"] == len(blob)
    for e in evs:
        if e["name"] == "decode.huffman":
            assert _inside(e, unpack) and e["args"]["symbols"] == u.size
    sl = next(e for e in evs if e["name"] == "decode.sl")
    assert sl["args"]["blocks"] > 0
    stages = [e["name"] for e in sorted(evs, key=lambda e: e["ts"])
              if e["name"] != "decode.huffman"]
    assert stages == ["decode.unpack", "decode.parse", "decode.sl",
                      "decode.reconstruct"]


def test_tiled_decode_spans_a_unit(obs_state):
    """A tiled decompress decodes unit by unit: one ``decode.sl`` (and
    one unpack, parse and reconstruction) a unit."""
    u, v = _advective()
    blob, st = repro_torch.compress(u, v, repro_torch.CompressionConfig(
        tiling=repro_torch.TileGrid(tile_h=24, tile_w=32, window_t=3),
        track_index=False, **ADV), device="cpu")
    assert st["n_units"] > 1
    obs.enable()
    trace.reset()
    repro_torch.decompress(blob, device="cpu")
    counts = collections.Counter(e["name"] for e in obs.trace_events()
                                 if e["ph"] == "X")
    for name in ("decode.unpack", "decode.parse", "decode.sl",
                 "decode.reconstruct"):
        assert counts[name] == st["n_units"], name


@pytest.mark.parametrize("codec", ["host", "device"])
def test_obs_off_records_nothing_and_changes_nothing(obs_state, codec):
    """With obs off, a compress and a decompress add no trace event and
    no ``span.*`` histogram, and give the bytes and arrays they give
    with obs on."""
    u, v = _advective()
    cfg = repro_torch.CompressionConfig(codec=codec, **ADV)

    def spans():
        return {k: m["count"] for k, m in obs.snapshot().items()
                if k.startswith("span.")}

    blobs, decs = {}, {}
    for on in (True, False):
        (obs.enable if on else obs.disable)()
        trace.reset()
        before = spans()
        blobs[on], _ = repro_torch.compress(u, v, cfg, device="cpu")
        decs[on] = repro_torch.decompress(blobs[on], device="cpu")
        recorded = bool(obs.trace_events()) or spans() != before
        assert recorded == on
    assert blobs[True] == blobs[False]
    for a, b in zip(decs[True], decs[False]):
        assert np.array_equal(a, b)


def test_zero_unix_us_aligns_spans_with_the_profiler(obs_state):
    """``trace.zero_unix_us`` alone puts the trace's spans on
    ``torch.profiler``'s axis: two spans half a second apart start
    within 1 ms of the profiler ranges opened inside them."""
    from torch.profiler import ProfilerActivity, profile, record_function

    obs.enable()
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):   # the first range pays a set-up
            pass
        for name in ("clock.first", "clock.last"):
            with obs.span(name), record_function(name):
                time.sleep(0.25)
    zero = trace.zero_unix_us()
    ranges = {e.name(): e.start_ns() / 1e3
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("clock.")}
    spans = {e["name"]: e["ts"] for e in obs.trace_events()}
    assert set(ranges) == {"clock.first", "clock.last"}
    for name, start in ranges.items():
        assert abs(spans[name] + zero - start) < 1e3, name
