"""Crash recovery, salvage, degraded reads and fault injection of the
port, against the JAX package (CPU).

* ``core/faults.py``: FaultPlan / FaultPoint semantics, bounded retry;
* ``compress_stream(..., sink=path)`` killed by an injected fault at
  several frames, on each engine, and resumed with ``resume=True``
  finishes the reference's bytes; double crash, torn journal tail,
  mismatched config, resume of a finished container, ``resume_info``;
  one run killed by SIGKILL in a fresh interpreter (the fsync order);
* ``encode.salvage_container`` gives the reference's bytes;
* degraded region and track decodes report exactly the damaged unit;
* ContainerSource retries; writer / ingest faults propagate; the
  watchdog fires.

Mirrors tests/test_recovery.py and tests/test_faults.py.
"""
import pytest

pytest.importorskip("torch")

import io
import os
import signal
import subprocess
import sys
import time

import numpy as np

import repro.core as core
from repro.core import encode as r_encode
import repro_torch
from repro_torch.analysis import query
from repro_torch.core import encode, stream_engine
from repro_torch.core import faults as faults_mod
from repro_torch.core.faults import (
    FaultPlan,
    FaultPoint,
    InjectedFault,
    InjectedThreadDeath,
    retry_transient,
)
from repro_torch.data import synthetic

GRID = repro_torch.TileGrid(8, 12, 3)
CFG = repro_torch.CompressionConfig(track_index=True)
ENGINES = {"serial": False, "async": True}
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _stream(pairs, cfg=CFG, **kw):
    return repro_torch.compress_stream(pairs, cfg, GRID, device="cpu", **kw)


@pytest.fixture(scope="module")
def field():
    u, v = synthetic.double_gyre(T=18, H=16, W=24)
    vr = (float(min(u.min(), v.min())), float(max(u.max(), v.max())))
    return u, v, list(zip(u, v)), vr


@pytest.fixture(scope="module")
def reference(field):
    """The JAX package's container of the field (numpy SL stepper)."""
    u, v, _, _ = field
    return core.compress_tiled(
        u, v, core.CompressionConfig(track_index=True, backend="numpy"),
        core.TileGrid(8, 12, 3))[0]


def _feed(pairs):
    return lambda t0: iter(pairs[t0:])


# ---------------------------------------------------------------- plan

def test_plan_fires_on_exact_call_number():
    plan = FaultPlan().io_error("x", nth=3)
    plan.check("x")
    plan.check("x")
    with pytest.raises(InjectedFault):
        plan.check("x")
    plan.check("x")                        # one-shot: later calls pass
    assert plan.calls("x") == 4
    assert plan.fired("x") == 1
    assert plan.log == [("x", "io_error", 3)]


def test_plan_sites_are_independent_and_transient_windows_close():
    plan = FaultPlan().io_error("a", nth=1).io_error("x", nth=2,
                                                     transient=2)
    plan.check("b")
    with pytest.raises(InjectedFault):
        plan.check("a")
    plan.check("x")
    for _ in range(3):                     # calls 2, 3, 4 raise
        with pytest.raises(InjectedFault):
            plan.check("x")
    plan.check("x")                        # call 5 succeeds
    assert plan.fired("x") == 3 and plan.fired() == 4


def test_spread_is_seed_deterministic():
    a = [FaultPlan(seed=7).spread(1, 100) for _ in range(5)]
    assert a == [FaultPlan(seed=7).spread(1, 100) for _ in range(5)]
    assert all(1 <= x <= 100 for x in a)


def test_thread_death_stall_and_fault_point():
    assert not issubclass(InjectedThreadDeath, Exception)
    with pytest.raises(InjectedThreadDeath):
        FaultPlan().thread_death("x").check("x")
    plan = FaultPlan().stall("x", seconds=0.05)
    t0 = time.monotonic()
    plan.check("x")
    assert time.monotonic() - t0 >= 0.05
    FaultPoint(None).check("anything")
    assert not FaultPoint(None) and FaultPoint(FaultPlan())
    with pytest.raises(ValueError, match="nth"):
        FaultPlan().io_error("x", nth=0)


def test_retry_transient_recovers_counts_and_bounds():
    faults_mod.reset_retry_stats()
    plan = FaultPlan().io_error("x", nth=1, transient=1)
    notes = []
    out = retry_transient(lambda: (plan.check("x"), "ok")[1], retries=3,
                          backoff=0, on_retry=lambda n, e: notes.append(n),
                          site="t.x")
    assert out == "ok" and notes == [1, 2]
    plan = FaultPlan().io_error("y", nth=1, transient=99)
    with pytest.raises(InjectedFault):
        retry_transient(lambda: plan.check("y"), retries=2, backoff=0,
                        site="t.y")
    assert plan.calls("y") == 3            # 1 try + 2 retries, no more
    plan = FaultPlan().thread_death("z")
    with pytest.raises(InjectedThreadDeath):
        retry_transient(lambda: plan.check("z"), retries=5, backoff=0)
    assert plan.calls("z") == 1
    st = faults_mod.retry_stats()
    assert st["t.x"]["retries"] == 2 and st["t.x"]["last_outcome"] == "ok"
    assert st["t.y"]["failures"] == 1 and st["t.y"]["attempts"] == 3
    assert faults_mod.retry_stats("none") == {}
    faults_mod.reset_retry_stats()
    assert faults_mod.retry_stats() == {}


# ------------------------------------------------------ journal/resume

def test_stream_to_path_equals_reference(field, reference, tmp_path):
    _, _, pairs, vr = field
    p = tmp_path / "c.cptt"
    blob, st = _stream(_feed(pairs), value_range=vr, sink=str(p))
    assert blob is None and st["resumed_from"] == 0
    assert p.read_bytes() == reference
    assert not os.path.exists(str(p) + ".journal")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("nth", [2, 9, 14, 17])
def test_kill_and_resume_byte_identical(field, reference, tmp_path, nth,
                                        engine):
    """Crash at frame ``nth`` (before the first checkpoint through the
    last window), resume, byte-compare with the reference."""
    _, _, pairs, vr = field
    p = tmp_path / "crash.cptt"
    plan = FaultPlan().io_error("stream.compute", nth=nth)
    with pytest.raises(InjectedFault):
        _stream(_feed(pairs), value_range=vr, sink=str(p),
                async_engine=ENGINES[engine], faults=plan)
    info = stream_engine.resume_info(str(p))
    assert info["resumable"] and not info["complete"]
    _, st = _stream(_feed(pairs), value_range=vr, sink=str(p), resume=True,
                    async_engine=ENGINES[engine])
    assert st["resumed_from"] == info["resume_from"]
    assert p.read_bytes() == reference
    assert not os.path.exists(str(p) + ".journal")


def test_resume_skips_a_plain_iterable_forward(field, reference, tmp_path):
    _, _, pairs, vr = field
    p = tmp_path / "it.cptt"
    with pytest.raises(InjectedFault):
        _stream(iter(pairs), value_range=vr, sink=str(p),
                faults=FaultPlan().io_error("stream.compute", nth=14))
    _, st = _stream(iter(pairs), value_range=vr, sink=str(p), resume=True)
    assert st["resumed_from"] > 0 and p.read_bytes() == reference


def test_double_crash_then_resume(field, reference, tmp_path):
    _, _, pairs, vr = field
    p = tmp_path / "crash2.cptt"
    with pytest.raises(InjectedFault):
        _stream(_feed(pairs), value_range=vr, sink=str(p),
                faults=FaultPlan().io_error("stream.compute", nth=16))
    with pytest.raises(InjectedFault):
        _stream(_feed(pairs), value_range=vr, sink=str(p), resume=True,
                async_engine=True,
                faults=FaultPlan().io_error("stream.compute", nth=2))
    _stream(_feed(pairs), value_range=vr, sink=str(p), resume=True)
    assert p.read_bytes() == reference


def test_torn_journal_tail_is_tolerated(field, reference, tmp_path):
    _, _, pairs, vr = field
    p = tmp_path / "torn.cptt"
    with pytest.raises(InjectedFault):
        _stream(_feed(pairs), value_range=vr, sink=str(p),
                faults=FaultPlan().io_error("stream.compute", nth=17))
    jp = str(p) + ".journal"
    raw = open(jp, "rb").read()
    n_intact = len(encode.read_journal(jp))
    open(jp, "wb").write(raw[:-7])         # tear mid-record
    assert len(encode.read_journal(jp)) == n_intact - 1
    _stream(_feed(pairs), value_range=vr, sink=str(p), resume=True)
    assert p.read_bytes() == reference


def test_resume_of_complete_container_is_noop(field, reference, tmp_path):
    _, _, pairs, vr = field
    p = tmp_path / "done.cptt"
    p.write_bytes(reference)
    info = stream_engine.resume_info(str(p))
    assert info["complete"] and not info["resumable"]
    assert info["n_units"] == len(encode.tiled_header(reference)["units"])
    blob, st = _stream(_feed(pairs), value_range=vr, sink=str(p),
                       resume=True)
    assert blob is None and st["already_complete"]
    assert p.read_bytes() == reference


def test_resume_info_of_nothing_and_of_a_crash_before_any_checkpoint(
        field, tmp_path):
    _, _, pairs, vr = field
    p = tmp_path / "early.cptt"
    info = stream_engine.resume_info(str(p))
    assert not info["complete"] and not info["resumable"]
    assert isinstance(info["retries"], dict)
    with pytest.raises(InjectedFault):
        _stream(_feed(pairs), value_range=vr, sink=str(p),
                faults=FaultPlan().io_error("stream.compute", nth=2))
    info = stream_engine.resume_info(str(p))
    assert info["resumable"] and info["resume_from"] == 0


def test_resume_refuses_mismatched_config(field, tmp_path):
    """The journal fingerprints (cfg, grid, value_range, H, W)."""
    _, _, pairs, vr = field
    p = tmp_path / "fp.cptt"
    with pytest.raises(InjectedFault):
        _stream(iter(pairs), value_range=vr, sink=str(p),
                faults=FaultPlan().io_error("stream.compute", nth=14))
    other = repro_torch.CompressionConfig(eb=3e-3, track_index=True)
    with pytest.raises(stream_engine.ResumeError):
        _stream(iter(pairs), other, value_range=vr, sink=str(p),
                resume=True)


@pytest.mark.parametrize("resume_env,resume_backend,refused", [
    (None, None, True), ("pallas", None, True), (None, "xla", False)])
def test_resume_fingerprints_the_sl_stepper(field, tmp_path, monkeypatch,
                                            resume_env, resume_backend,
                                            refused):
    """A run written with REPRO_BACKEND=xla resumes only under the same
    stepper: from the variable or from CompressionConfig.backend, and then
    finishes an uninterrupted "xla" run's bytes."""
    _, _, pairs, vr = field
    p = tmp_path / "sl.cptt"
    monkeypatch.setenv("REPRO_BACKEND", "xla")
    with pytest.raises(InjectedFault):
        _stream(iter(pairs), value_range=vr, sink=str(p),
                faults=FaultPlan().io_error("stream.compute", nth=14))
    if resume_env is None:
        monkeypatch.delenv("REPRO_BACKEND")
    else:
        monkeypatch.setenv("REPRO_BACKEND", resume_env)
    cfg = repro_torch.CompressionConfig(track_index=True,
                                        backend=resume_backend)
    if refused:
        with pytest.raises(stream_engine.ResumeError):
            _stream(iter(pairs), cfg, value_range=vr, sink=str(p),
                    resume=True)
        return
    _, st = _stream(iter(pairs), cfg, value_range=vr, sink=str(p),
                    resume=True)
    assert st["resumed_from"] > 0
    want, _ = _stream(iter(pairs), cfg, value_range=vr)
    assert p.read_bytes() == want
    assert encode.tiled_header(want)["sl_backend"] == "xla"


def test_journal_records_round_trip(tmp_path):
    """Journal records hold bytes, nested lists and ints above 2^32."""
    jp = str(tmp_path / "j.journal")
    rec = {"t": "ckpt", "bytes": 2 ** 40 + 3, "eb": [[5, b"\x00\x01" * 70]],
           "nested": [[1, [2, [3]]]], "f": -0.5, "n": None}
    w = encode.JournalWriter(jp)
    w.append({"t": "begin"})
    w.append(rec, sync=True)
    w.close()
    assert encode.read_journal(jp) == [{"t": "begin"}, rec]
    assert encode.read_journal(str(tmp_path / "absent")) == []
    (tmp_path / "bad").write_bytes(b"XXXXX")
    with pytest.raises(encode.ContainerError, match="journal"):
        encode.read_journal(str(tmp_path / "bad"))


_CHILD = r"""
import os, signal, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import repro_torch
from repro_torch.data import synthetic

u, v = synthetic.double_gyre(T=18, H=16, W=24)
kill_at, path = int(sys.argv[2]), sys.argv[3]
vr = (float(min(u.min(), v.min())), float(max(u.max(), v.max())))

def frames():
    for t in range(u.shape[0]):
        if t == kill_at:
            os.kill(os.getpid(), signal.SIGKILL)
        yield u[t], v[t]

repro_torch.compress_stream(
    frames(), repro_torch.CompressionConfig(track_index=True),
    repro_torch.TileGrid(8, 12, 3), value_range=vr, sink=path,
    device="cpu")
"""


@pytest.mark.parametrize("kill_at", [10, 17])
def test_sigkill_in_a_fresh_interpreter_then_resume(field, reference,
                                                    tmp_path, kill_at):
    """The child dies by SIGKILL before frame ``kill_at`` (mid-stream,
    and before the last frame): no handler runs, so only what was
    fsynced survives; the parent's resume finishes the reference's
    bytes."""
    _, _, pairs, vr = field
    p = tmp_path / "killed.cptt"
    res = subprocess.run([sys.executable, "-c", _CHILD, SRC, str(kill_at),
                          str(p)], capture_output=True, timeout=300)
    assert res.returncode == -signal.SIGKILL, res.stderr.decode()[-2000:]
    info = stream_engine.resume_info(str(p))
    assert info["resumable"] and 0 < info["resume_from"] < kill_at
    _, st = _stream(_feed(pairs), value_range=vr, sink=str(p), resume=True)
    assert st["resumed_from"] == info["resume_from"]
    assert p.read_bytes() == reference


def test_resume_needs_a_path_sink_and_a_value_range(field):
    _, _, pairs, vr = field
    with pytest.raises(ValueError, match="path"):
        _stream(iter(pairs), value_range=vr, sink=io.BytesIO(), resume=True)
    with pytest.raises(ValueError, match="value_range"):
        _stream(iter(pairs), sink="x.cptt", resume=True)


# ------------------------------------------------------------ salvage

def _cut_before_footer(blob):
    last = max(encode.tiled_header(blob)["units"], key=lambda e: e["off"])
    return blob[: last["off"] + last["len"]]


def test_salvage_bytes_equal_reference(reference):
    cut = _cut_before_footer(reference)
    blob, rep = encode.salvage_container(cut)
    ref_blob, ref_rep = r_encode.salvage_container(cut)
    assert blob == ref_blob and rep == ref_rep
    assert rep["units_recovered"] == len(
        encode.tiled_header(reference)["units"])
    assert rep["prologue_recovered"]
    assert encode.tiled_header(blob)["salvaged"] is True
    su, sv = repro_torch.decompress_tiled(blob, device="cpu")
    ru, rv = repro_torch.decompress_tiled(reference, device="cpu")
    assert np.array_equal(su, ru) and np.array_equal(sv, rv)
    # mid-frame truncation: the same partial directory as the reference
    units = sorted(encode.tiled_header(reference)["units"],
                   key=lambda e: e["off"])
    cut = reference[: units[len(units) // 2]["off"] + 5]
    got = encode.salvage_container(cut)
    assert got == r_encode.salvage_container(cut)
    assert got[1]["units_recovered"] == len(units) // 2


def test_salvage_to_a_file_and_from_a_path(reference, tmp_path):
    src = tmp_path / "cut.cptt"
    src.write_bytes(_cut_before_footer(reference)[:-100])
    out = tmp_path / "salvaged.cptt"
    res, rep = encode.salvage_container(str(src), out=str(out))
    assert res is None and rep["units_recovered"] > 0
    assert out.read_bytes() == r_encode.salvage_container(
        src.read_bytes())[0]
    repro_torch.decompress_tiled(str(out), device="cpu")


def test_salvage_refuses_non_container_and_lost_prologue(reference):
    with pytest.raises(encode.ContainerError):
        encode.salvage_container(b"not a container at all")
    ba = bytearray(_cut_before_footer(reference))
    # a byte of the prologue frame: its CRC fails, the walk resyncs
    ba[len(encode.MAGIC_TILED) + encode.PREAMBLE_LEN + 3] ^= 0xFF
    with pytest.raises(encode.ContainerError, match="prologue"):
        encode.salvage_container(bytes(ba))
    hdr = encode.tiled_header(reference)
    blob, rep = encode.salvage_container(
        bytes(ba), fallback_header={k: hdr[k] for k in hdr
                                    if k not in ("units", "track_index")})
    assert not rep["prologue_recovered"] and rep["units_recovered"] > 0
    assert blob == r_encode.salvage_container(
        bytes(ba), fallback_header={k: hdr[k] for k in hdr
                                    if k not in ("units", "track_index")})[0]


# ----------------------------------------------------- degraded reads

def _flip(blob: bytes, entry: dict) -> bytes:
    ba = bytearray(blob)
    ba[entry["off"] + entry["len"] // 2] ^= 0x20
    return bytes(ba)


def test_degraded_decode_reports_exactly_the_flipped_unit(reference):
    hdr = encode.tiled_header(reference)
    entry = hdr["units"][2]
    bad = _flip(reference, entry)
    with pytest.raises(encode.ChecksumError):
        repro_torch.decompress_tiled(bad, device="cpu")
    u_ref, v_ref = repro_torch.decompress_tiled(reference, device="cpu")
    u_d, v_d, rep = repro_torch.decompress_tiled(bad, device="cpu",
                                                 degraded=True)
    assert not rep.complete and rep.n_units == len(hdr["units"])
    assert rep.n_decoded == rep.n_units - 1
    assert [m["key"] for m in rep.missing_units] == [tuple(entry["key"])]
    t0, t1, i0, i1, j0, j1 = entry["box"]
    hole = np.zeros(u_ref.shape, bool)
    hole[t0:t1, i0:i1, j0:j1] = True
    assert np.array_equal(u_d[~hole], u_ref[~hole])
    assert np.array_equal(v_d[~hole], v_ref[~hole])
    assert not u_d[hole].any() and not v_d[hole].any()
    assert np.array_equal(rep.hole_mask((0,) + u_ref.shape[:1] + (0,)
                                        + u_ref.shape[1:2] + (0,)
                                        + u_ref.shape[2:]), hole)
    ru, rv, rrep = core.decompress_tiled(bad, degraded=True)
    assert np.array_equal(u_d, ru) and np.array_equal(v_d, rv)
    assert rrep.missing_units == rep.missing_units


def test_degraded_region_decode(reference):
    query.configure_unit_cache(0)
    try:
        entry = encode.tiled_header(reference)["units"][0]
        region = tuple(entry["box"])
        u_d, v_d, rep = repro_torch.decompress_region(
            _flip(reference, entry), region, device="cpu", degraded=True)
        assert rep.n_units == 1 and rep.n_decoded == 0
        assert not rep.complete and not u_d.any() and not v_d.any()
        ok_region = (0, 3, 0, 8, 0, 24)      # two units, one flipped
        u2, _, rep2 = repro_torch.decompress_region(
            _flip(reference, entry), ok_region, device="cpu", degraded=True)
        want, _ = repro_torch.decompress_region(reference, ok_region,
                                                device="cpu")
        assert rep2.n_units == 2 and rep2.n_decoded == 1
        assert np.array_equal(u2[~rep2.hole_mask(ok_region)],
                              want[~rep2.hole_mask(ok_region)])
    finally:
        query.configure_unit_cache(256)


def test_degraded_track_decode_drops_only_affected(reference):
    from repro.analysis import query as r_query

    query.configure_unit_cache(0)
    try:
        s = max(query.track_summaries(reference), key=lambda s: s["n_nodes"])
        tid = s["track_id"]
        full = query.decode_for_track(reference, tid, device="cpu")
        assert full.complete and full.track is not None
        cover = query.track_read_plan(reference, tid)
        bad = _flip(reference, cover[0])
        with pytest.raises(encode.ChecksumError):
            query.decode_for_track(bad, tid, device="cpu")
        d = query.decode_for_track(bad, tid, device="cpu", degraded=True)
        assert not d.complete
        assert [m["key"] for m in d.missing_units] == [tuple(cover[0]["key"])]
        assert d.segments_dropped > 0
        ref = {int(f): tuple(n) for f, n in
               zip(full.track.face_ids, full.track.nodes)}
        pieces = d.pieces or ((d.track,) if d.track is not None else ())
        n_nodes = 0
        for piece in pieces:
            for f, n in zip(piece.face_ids, piece.nodes):
                assert tuple(n) == ref[int(f)]
                n_nodes += 1
        assert 0 < n_nodes < len(full.track.face_ids)
        r_query.configure_unit_cache(0)
        rd = r_query.decode_for_track(bad, tid, backend="numpy",
                                      degraded=True)
        assert rd.segments_dropped == d.segments_dropped
        assert len(rd.pieces) == len(d.pieces)
        for a, b in zip(rd.pieces, d.pieces):
            assert np.array_equal(a.nodes, b.nodes)
            assert np.array_equal(a.face_ids, b.face_ids)
            assert np.array_equal(a.types, b.types)
    finally:
        query.configure_unit_cache(256)
        r_query.configure_unit_cache(256)


def test_degraded_decode_of_salvaged_truncation(reference):
    units = sorted(encode.tiled_header(reference)["units"],
                   key=lambda e: e["off"])
    blob, _ = encode.salvage_container(
        reference[: units[len(units) // 2]["off"] + 5])
    u_ref, _ = repro_torch.decompress_tiled(reference, device="cpu")
    u_d, _, drep = repro_torch.decompress_tiled(blob, device="cpu",
                                                degraded=True)
    assert drep.complete
    for ent in encode.tiled_header(blob)["units"]:
        t0, t1, i0, i1, j0, j1 = ent["box"]
        assert np.array_equal(u_d[t0:t1, i0:i1, j0:j1],
                              u_ref[t0:t1, i0:i1, j0:j1])


# ------------------------------------------- ContainerSource consumers

def test_source_retries_transient_reads_and_reports_them(reference,
                                                         tmp_path):
    faults_mod.reset_retry_stats()
    p = tmp_path / "c.cptt"
    p.write_bytes(reference)
    plan = FaultPlan().io_error("source.read", nth=1, transient=1)
    src = query.ContainerSource(str(p), faults=plan, retries=2, backoff=0)
    u, _, rep = repro_torch.decompress_tiled(src, device="cpu",
                                             degraded=True)
    assert src.retried == 2 and rep.complete
    assert rep.retries["source.read"]["retries"] == 2
    src.close()
    plan = FaultPlan().io_error("source.read", nth=1, transient=99)
    src = query.ContainerSource(reference, faults=plan, retries=1,
                                backoff=0)
    with pytest.raises(InjectedFault):
        src.read(0, 5)


def test_host_pool_worker_fault_reaches_caller(reference, tmp_path):
    p = tmp_path / "c.cptt"
    p.write_bytes(reference)
    units = encode.tiled_header(reference)["units"]
    plan = FaultPlan().io_error("source.read", nth=3)
    src = query.ContainerSource(str(p), faults=plan)
    with pytest.raises(OSError):
        src.read_many(units)
    failures = []
    frames = query.ContainerSource(str(p), faults=FaultPlan().io_error(
        "source.read", nth=2)).read_many(units, failures=failures)
    assert sum(f is None for f in frames) == len(failures) == 1


# ------------------------------------------------- async engine paths

def _small():
    u, v = synthetic.double_gyre(T=10, H=16, W=24)
    vr = (float(min(u.min(), v.min())), float(max(u.max(), v.max())))
    return list(zip(u, v)), vr


def test_compute_failure_with_full_writer_queue_no_deadlock():
    pairs, vr = _small()
    t0 = time.monotonic()
    with pytest.raises(InjectedFault):
        _stream(iter(pairs), value_range=vr, sink=io.BytesIO(),
                async_engine=True, stage_timeout=30.0,
                faults=FaultPlan().io_error("stream.compute", nth=8))
    assert time.monotonic() - t0 < 30.0


def test_writer_thread_fault_propagates(tmp_path):
    pairs, vr = _small()
    with pytest.raises(InjectedFault):
        _stream(iter(pairs), value_range=vr, sink=str(tmp_path / "w.cptt"),
                async_engine=True,
                faults=FaultPlan().io_error("stream.write", nth=2))


def test_ingest_thread_death_propagates():
    pairs, vr = _small()
    with pytest.raises(InjectedThreadDeath):
        _stream(iter(pairs), value_range=vr, sink=io.BytesIO(),
                async_engine=True,
                faults=FaultPlan().thread_death("stream.ingest", nth=3))


def test_writer_stall_trips_watchdog(monkeypatch):
    """A writer stalled past the stage timeout raises EngineStallError;
    the timeout also comes from REPRO_STAGE_TIMEOUT.  The stall outlives
    the compute on a loaded machine; the engine waits at most 10 s for
    the stalled daemon writer before it returns."""
    pairs, vr = _small()
    monkeypatch.setenv("REPRO_STAGE_TIMEOUT", "0.2")
    assert stream_engine._stage_timeout(None) == 0.2
    t0 = time.monotonic()
    with pytest.raises(stream_engine.EngineStallError):
        _stream(iter(pairs), value_range=vr, sink=io.BytesIO(),
                async_engine=True,
                faults=FaultPlan().stall("stream.write", seconds=60.0,
                                         nth=1))
    assert time.monotonic() - t0 < 30.0


def test_engine_and_journal_obs_names(field, reference, tmp_path):
    """With tracing on, the engine and the journal report under the
    reference's names: spans engine.ingest / compute / write and
    journal.checkpoint, counters engine.units_emitted and
    journal.resumes, queue-depth events q_in / q_out."""
    from repro_torch import obs

    _, _, pairs, vr = field
    p = tmp_path / "traced.cptt"
    obs.reset()
    obs.enable()
    try:
        with pytest.raises(InjectedFault):
            _stream(_feed(pairs), value_range=vr, sink=str(p),
                    async_engine=True,
                    faults=FaultPlan().io_error("stream.compute", nth=14))
        _stream(_feed(pairs), value_range=vr, sink=str(p), resume=True,
                async_engine=True)
        spans = obs.stage_durations("")
        snap = obs.snapshot()
        events = {e.get("name") for e in obs.trace_events()}
    finally:
        obs.disable()
        obs.reset()
    assert p.read_bytes() == reference
    for name in ("engine.ingest", "engine.compute", "engine.write",
                 "journal.checkpoint"):
        assert spans[name]["count"] > 0, name
    assert snap["engine.units_emitted"]["value"] > 0
    assert snap["journal.resumes"]["value"] == 1
    assert {"engine.q_in", "engine.q_out"} <= events
