"""The port's streaming compression against the JAX package (CPU).

``repro_torch.compress_stream(..., device="cpu")`` -- the serial engine
and the three-stage async engine -- must write the bytes of the port's
``compress_tiled``, which are the bytes of
``repro.core.compress_tiled(..., backend="numpy")``: CPTT1 version 4
(host codec), 5 (device codec) and 6 (adaptive policy), with the track
index, with ``batch_units=False``, into no sink, a BytesIO or a path,
with and without ``value_range``, and on a field whose verify rounds
fire.  The plane store keeps only the frames the first pending window
needs.  Mirrors tests/test_tiled_streaming.py and
tests/test_stream_async.py.  All comparisons are exact.
"""
import io
import sys

import numpy as np
import pytest

import repro.core as core
from repro.core import ebpolicy as r_ebpolicy
import repro_torch
from repro_torch.core import compressor, ebpolicy, encode, stream_engine, \
    tiling
from repro_torch.data import synthetic

GRID = (8, 12, 3)
META = dict(mode="rel", dt=0.1, dx=2.0 / 23, dy=1.0 / 15)
CASES = {
    "host": dict(eb=1e-2),
    "device": dict(eb=1e-2, codec="device"),
    "no-batch": dict(eb=1e-2, batch_units=False),
}
ENGINES = {"serial": False, "async": True}
CPU = compressor.resolve_device("cpu")


def _policy_kw(mod):
    pol = mod.TilePolicy.make(3, 8, 12, default=1e-2,
                              values={(0, 0, 0): 2e-3, (1, 1, 1): 5e-3})
    return dict(eb=1e-2, eb_policy=pol, n_levels=mod.levels_for(pol))


def _kw(name, mod):
    return _policy_kw(mod) if name == "adaptive" else CASES[name]


def _frames(u, v):
    return ((u[t], v[t]) for t in range(u.shape[0]))


def _vrange(u, v):
    return (float(min(u.min(), v.min())), float(max(u.max(), v.max())))


@pytest.fixture(scope="module")
def field():
    return synthetic.double_gyre(T=10, H=16, W=24)


@pytest.fixture(scope="module")
def ref_blobs(field):
    """The JAX package's tiled containers (numpy SL stepper)."""
    u, v = field
    return {name: core.compress_tiled(
        u, v, core.CompressionConfig(backend="numpy", **META,
                                     **_kw(name, r_ebpolicy)),
        core.TileGrid(*GRID))[0]
        for name in ("host", "device", "adaptive", "no-batch")}


def _cfg(name, **extra):
    return repro_torch.CompressionConfig(**META, **_kw(name, ebpolicy),
                                         **extra)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", ["host", "device", "adaptive", "no-batch"])
def test_stream_bytes_equal_tiled_and_reference(field, ref_blobs, name,
                                                engine):
    u, v = field
    cfg = _cfg(name)
    tiled, st_t = repro_torch.compress_tiled(u, v, cfg,
                                             repro_torch.TileGrid(*GRID),
                                             device="cpu")
    blob, st = repro_torch.compress_stream(
        _frames(u, v), cfg, repro_torch.TileGrid(*GRID),
        value_range=_vrange(u, v), async_engine=ENGINES[engine],
        device="cpu")
    assert blob == tiled == ref_blobs[name]
    hdr = encode.tiled_header(blob)
    assert hdr["version"] == {"host": 4, "device": 5, "adaptive": 6,
                              "no-batch": 4}[name]
    assert encode.TRACK_INDEX_KEY in hdr
    assert st["async_engine"] is ENGINES[engine]
    assert st["n_units"] == st_t["n_units"] == len(hdr["units"])
    assert st["chunks"]["emit"] == st_t["chunks"]["emit"]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("sink", ["bytesio", "path"])
def test_stream_writes_to_sink(field, ref_blobs, tmp_path, sink, engine):
    u, v = field
    out = io.BytesIO() if sink == "bytesio" else str(tmp_path / "s.cptt")
    blob, st = repro_torch.compress_stream(
        _frames(u, v), _cfg("host"), repro_torch.TileGrid(*GRID),
        value_range=_vrange(u, v), sink=out, async_engine=ENGINES[engine],
        device="cpu")
    assert blob is None and st["comp_bytes"] == len(ref_blobs["host"])
    got = out.getvalue() if sink == "bytesio" else \
        (tmp_path / "s.cptt").read_bytes()
    assert got == ref_blobs["host"]
    # a finished path run leaves no journal behind
    assert not (tmp_path / "s.cptt.journal").exists()


@pytest.mark.parametrize("engine", ENGINES)
def test_stream_without_range_materializes(field, ref_blobs, engine):
    """No value_range: the serial engine hands the materialized field to
    compress_tiled, the async engine still runs on the exact range."""
    u, v = field
    blob, st = repro_torch.compress_stream(
        _frames(u, v), _cfg("host"), repro_torch.TileGrid(*GRID),
        async_engine=ENGINES[engine], device="cpu")
    assert blob == ref_blobs["host"]
    assert st.get("async_engine", False) is ENGINES[engine]


def test_async_engine_under_thread_switch_stress(field, ref_blobs):
    """The three stages share the writer's state: with the thread switch
    interval cut to a microsecond and both queues at their smallest, the
    async engine still writes the reference's bytes."""
    u, v = field
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for name in ("host", "device"):
            blob, st = repro_torch.compress_stream(
                _frames(u, v), _cfg(name, q_in_frames=2, q_out_units=2),
                repro_torch.TileGrid(*GRID), value_range=_vrange(u, v),
                async_engine=True, stage_timeout=60.0, device="cpu")
            assert blob == ref_blobs[name]
            assert st["n_units"] == len(encode.tiled_header(blob)["units"])
    finally:
        sys.setswitchinterval(old)


def test_stream_takes_the_grid_from_the_config(field, ref_blobs):
    u, v = field
    cfg = _cfg("host", tiling=repro_torch.TileGrid(*GRID))
    blob, _ = repro_torch.compress_stream(_frames(u, v), cfg,
                                          value_range=_vrange(u, v),
                                          device="cpu")
    assert blob == ref_blobs["host"]


def _large_magnitude(T):
    rng = np.random.default_rng(3)
    base = 1.0e8
    u = (base + rng.normal(0, 100.0, (T, 16, 16))).astype(np.float32)
    v = (base + rng.normal(0, 100.0, (T, 16, 16))).astype(np.float32)
    return u, v


@pytest.fixture(scope="module")
def big():
    u, v = _large_magnitude(6)
    ref, st = core.compress_tiled(
        u, v, core.CompressionConfig(eb=6.0, mode="abs", backend="numpy"),
        core.TileGrid(8, 8, 2))
    return u, v, ref, st


@pytest.mark.parametrize("engine", ENGINES)
def test_rounds_firing_field_bitwise(big, engine):
    """f32 output rounding competes with the bound, so verify rounds fire
    (rounds >= 1); the streamed fixpoint still lands on the reference's
    bytes."""
    u, v, ref, st_r = big
    assert st_r["verify_rounds"] >= 1
    blob, st = repro_torch.compress_stream(
        _frames(u, v), repro_torch.CompressionConfig(eb=6.0, mode="abs"),
        repro_torch.TileGrid(8, 8, 2), value_range=_vrange(u, v),
        async_engine=ENGINES[engine], device="cpu")
    assert blob == ref
    assert st["verify_rounds"] >= 1


def test_cascade_below_the_frontier_raises():
    """A forcing round that lands below the frontier (an already-written
    frame) raises instead of silently diverging from compress_tiled."""
    u, v = _large_magnitude(6)
    cfg = repro_torch.CompressionConfig(eb=6.0, mode="abs")
    st, windows, T = tiling._prepare(u, v, cfg, repro_torch.TileGrid(8, 8, 2),
                                     None, CPU)
    with pytest.raises(tiling.StreamingCascadeError, match="frontier"):
        tiling._fixpoint(st, windows, frontier=T)
    # frontier 0 (compress_tiled's) runs the same rounds to the fixpoint
    st, windows, _ = tiling._prepare(u, v, cfg, repro_torch.TileGrid(8, 8, 2),
                                     None, CPU)
    tiling._fixpoint(st, windows, frontier=0)
    assert st.rounds >= 1


def test_fixpoint_rechecks_only_the_delta(field):
    """A second fixpoint call over already-screened windows checks no
    unit (nothing was forced since): the streamed schedule adds no
    verify chunks for a pending window."""
    u, v = field
    st, windows, _ = tiling._prepare(u, v, _cfg("host"),
                                     repro_torch.TileGrid(*GRID), None, CPU)
    tiling._fixpoint(st, windows[:2])
    before = dict(st.chunks["verify"])
    assert all(s.key in st.seen for w in windows[:2] for s in w.specs)
    tiling._fixpoint(st, windows[:2])
    assert st.chunks["verify"] == before
    tiling._fixpoint(st, windows[:3])
    assert sum(st.chunks["verify"].values()) > sum(before.values())


@pytest.mark.parametrize("engine", ENGINES)
def test_resident_frames_stay_within_the_bound(monkeypatch, engine):
    """After every frame, the plane stores (u, v, ufp, vfp, eb, forced)
    hold only frames from the first pending window's t0 - thalo on, and
    a long stream never holds more than 3 windows + 2 halos - 1."""
    u, v = synthetic.double_gyre(T=20, H=16, W=24)
    grid = repro_torch.TileGrid(8, 12, 3)
    seen = []
    orig = stream_engine.Scheduler.add_frame

    def add_frame(self, *a):
        orig(self, *a)
        stores = [self.st.u, self.st.v, self.st.ufp, self.st.vfp,
                  self.st.eb, self.st.forced]
        lo = self.pending[0].t0 - grid.thalo if self.pending else 0
        for p in stores:
            assert min(p.p, default=lo) >= lo
        seen.append(max(len(p.p) for p in stores))

    monkeypatch.setattr(stream_engine.Scheduler, "add_frame", add_frame)
    blob, _ = repro_torch.compress_stream(
        _frames(u, v), _cfg("host"), grid, value_range=_vrange(u, v),
        async_engine=ENGINES[engine], device="cpu")
    assert len(seen) == 20
    # the frame before a window's derivation: kept from two windows
    # back less a halo
    assert max(seen) == 3 * grid.window_t + 2 * grid.thalo - 1 < 20
    tiled, _ = repro_torch.compress_tiled(u, v, _cfg("host"), grid,
                                          device="cpu")
    assert blob == tiled


def test_adaptive_bound_planes_are_dropped_too(monkeypatch):
    u, v = synthetic.double_gyre(T=14, H=16, W=24)
    grid = repro_torch.TileGrid(8, 12, 3)
    sizes = []
    orig = stream_engine.Scheduler.add_frame

    def add_frame(self, *a):
        orig(self, *a)
        sizes.append(len(self.st.ebf.p))

    monkeypatch.setattr(stream_engine.Scheduler, "add_frame", add_frame)
    repro_torch.compress_stream(_frames(u, v), _cfg("adaptive"), grid,
                                value_range=_vrange(u, v), device="cpu")
    assert max(sizes) <= 3 * grid.window_t + 2 * grid.thalo - 1 < 14


@pytest.mark.parametrize("engine", ENGINES)
def test_too_few_frames(engine):
    u, v = synthetic.double_gyre(T=2, H=16, W=24)
    with pytest.raises(ValueError, match="at least 2 frames"):
        repro_torch.compress_stream(iter([(u[0], v[0])]), _cfg("host"),
                                    repro_torch.TileGrid(*GRID),
                                    value_range=(-1.0, 1.0),
                                    async_engine=ENGINES[engine],
                                    device="cpu")


@pytest.mark.parametrize("engine", ENGINES)
def test_single_frame_tail_window(engine):
    u, v = synthetic.double_gyre(T=7, H=16, W=24)
    grid = repro_torch.TileGrid(16, 24, 3)
    tiled, _ = repro_torch.compress_tiled(u, v, _cfg("host"), grid,
                                          device="cpu")
    blob, _ = repro_torch.compress_stream(
        _frames(u, v), _cfg("host"), grid, value_range=_vrange(u, v),
        async_engine=ENGINES[engine], device="cpu")
    assert blob == tiled


def test_async_source_error_propagates():
    u, v = synthetic.double_gyre(T=6, H=16, W=24)

    def bad_frames():
        for t in range(4):
            yield u[t], v[t]
        raise OSError("simulated source failure")

    with pytest.raises(OSError, match="simulated source failure"):
        repro_torch.compress_stream(bad_frames(), _cfg("host"),
                                    repro_torch.TileGrid(*GRID),
                                    value_range=_vrange(u, v),
                                    async_engine=True, device="cpu")


def test_async_sink_error_propagates(field):
    u, v = field

    class BadSink:
        def __init__(self):
            self.n = 0

        def write(self, data):
            self.n += len(data)
            if self.n > 4096:
                raise OSError("simulated sink failure")

    with pytest.raises(OSError, match="simulated sink failure"):
        repro_torch.compress_stream(_frames(u, v), _cfg("host"),
                                    repro_torch.TileGrid(*GRID),
                                    value_range=_vrange(u, v),
                                    sink=BadSink(), async_engine=True,
                                    device="cpu")


def test_frame_of_the_wrong_shape_refused():
    u, v = synthetic.double_gyre(T=4, H=16, W=24)
    frames = [(u[0], v[0]), (u[1][:, :-1], v[1][:, :-1])]
    with pytest.raises(ValueError, match="shape"):
        repro_torch.compress_stream(iter(frames), _cfg("host"),
                                    repro_torch.TileGrid(*GRID),
                                    value_range=_vrange(u, v), device="cpu")
