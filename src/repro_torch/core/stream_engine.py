"""Streaming engines of compress_stream (the JAX package's
``core/stream_engine.py``): the serial loop and the three-stage async
engine, the write-ahead journal and crash resume.

Both engines run one window state machine (``Scheduler``): derive every
window whose halo extension is buffered, run the seam-agreed fixpoint
over derived-but-unwritten windows, write a window once the next
window's fixpoint has run, and drop the frames behind the first pending
window.  The async engine overlaps three stages:

    ingest thread   -- pulls (u_t, v_t) frames from the source, converts
                       them to float32 and computes the fixed-point
                       planes (host numpy), over a bounded queue;
    compute thread  -- the caller's thread: owns the plane store and ALL
                       device work -- window derivation, the fixpoint,
                       the final encode, the device codec, and every
                       copy of a result to the host (core/tiling.py
                       ``_unit_payloads``), which with several cards it
                       fans out to the tiles mesh's workers and awaits;
    writer thread   -- takes host-only unit payloads in emission order:
                       symbolize, pack, TiledWriter, track-index rows,
                       the journal.

No kernel is launched and no device memory is touched on the ingest or
writer thread: the compute thread's work (and its tiles workers', each
on a stream of its own, synchronized before the results come back)
is done before a payload reaches the writer.  Payloads leave the scheduler in the serial emission order and
the writer queue is FIFO, so the bytes are the serial engine's (and
compress_tiled's).

Memory: the plane store holds the frames from the first pending
window's ``t0 - thalo`` on; the ingest queue holds ``q_in_frames``
frames (default one window) and the writer queue ``q_out_units`` unit
payloads (default two windows' units).

Crash recovery: with a filesystem-path sink, ``_Session`` keeps
``<path>.journal``: a ``begin`` fingerprint record, one record per
written unit (directory entry, index rows, counters) and an fsynced
``ckpt`` record at each emission boundary (the scheduler frontier and
the eb / forced planes still resident).  ``resume=True`` truncates the
container to the last checkpoint, restores the writer, scheduler and
planes, and feeds frames from ``resume_from`` on; re-derivation
min-reduces the same bounds into the restored planes and the restored
forced planes are at the last fixpoint, so the finished container is
byte-identical to an uninterrupted run.  The fingerprint holds the
config, grid, value range and plane size, not the device: the bytes
are equal on every device, so a journal written on the card resumes on
the CPU and the other way round.

Failure containment: the first failing stage's exception reaches the
caller; both bounded queues are poisoned without blocking; with
``stage_timeout`` (or REPRO_STAGE_TIMEOUT) a stalled stage raises
EngineStallError.  core/faults.py injects the faults.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
import zlib

import numpy as np

from . import _msgpack, backend, ebpolicy, encode, tiling
from . import faults as faults_mod
from .. import obs


class EngineStallError(RuntimeError):
    """A pipeline stage made no progress within the watchdog timeout."""


class ResumeError(ValueError):
    """The journal's run fingerprint does not match this invocation
    (different config/grid/value_range/shape): resuming would splice
    incompatible bytes into the container."""


def _stage_timeout(value):
    if value is not None:
        return float(value)
    env = os.environ.get("REPRO_STAGE_TIMEOUT")
    return float(env) if env else None


class Scheduler:
    """The window state machine shared by the serial and async engines:
    derive every window whose halo extension is fully buffered,
    run the seam-agreed fixpoint over derived-but-unemitted windows,
    emit each window once the NEXT window's fixpoint has run (its
    verify outcome is then sealed), and drop frame planes behind the
    pending frontier.  ``emit`` receives ``_UnitPayload`` objects in
    the canonical emission order; the engines differ only in where
    that callable runs the CPU pack.

    ``checkpoint`` (optional) is called after each emission burst with
    a msgpack-able snapshot of everything a crash resume needs: the
    frontier, the first-unemitted window index, and the eb/forced
    planes of every still-resident frame.  Restoring that snapshot and
    re-feeding frames from ``resume_from`` reproduces the exact
    remaining emissions: re-derivation min-reduces the SAME eb values
    into the restored planes (idempotent), and the restored forced
    planes are already at the last fixpoint, so re-run verify rounds
    add nothing.
    """

    def __init__(self, st, cfg, grid, emit, checkpoint=None):
        self.st = st
        self.cfg = cfg
        self.grid = grid
        self.emit = emit
        self.checkpoint = checkpoint
        self.windows = []       # every derived window, in order
        self.pending = []       # derived, not yet emitted (ordered)
        self.frontier = 0       # frames below this are sealed
        self.next_w = 0         # next window index to derive
        self.T = 0
        self.eof = False
        # units handed to emit, ever -- a per-scheduler view over the
        # process-wide "engine.units_emitted" obs counter (kept as a
        # public field because checkpoints snapshot it)
        self._c_emitted = obs.child_counter("engine.units_emitted")
        self._c_windows = obs.child_counter("engine.windows_emitted")

    @property
    def n_emitted(self) -> int:
        return self._c_emitted.value

    def add_frame(self, u_t, v_t, ufp_t=None, vfp_t=None):
        tiling._add_frame(self.st, self.T, u_t, v_t, ufp_t, vfp_t)
        self.T += 1
        if self._derive_ready():
            self._advance()

    def finish(self):
        self.eof = True
        self._derive_ready()
        self._advance()
        if self.pending:
            raise RuntimeError("scheduler left unemitted windows")

    def restore(self, ckpt: dict):
        """Adopt a journal checkpoint: resume scheduling exactly where
        the interrupted run's last durable emission left off."""
        self.frontier = int(ckpt["frontier"])
        self.next_w = int(ckpt["next_w"])
        self.T = int(ckpt["resume_from"])
        # restored units were emitted by the CRASHED run: reset only
        # this scheduler's view so n_emitted matches the checkpoint
        # without double-counting them in the process-wide counter
        self._c_emitted.set_local(int(ckpt["n_units"]))

    def _derive_ready(self):
        """Derive every window whose extension is fully buffered."""
        st, grid = self.st, self.grid
        out = []
        while True:
            t0 = self.next_w * grid.window_t
            if t0 >= self.T:
                break
            t1 = min(t0 + grid.window_t, self.T)
            full = t1 == t0 + grid.window_t and self.T >= t1 + grid.thalo
            if not (full or self.eof):
                break
            et1 = min(t1 + grid.thalo, self.T)
            w = tiling._Window(
                self.next_w, t0, t1,
                tiling.window_specs(self.next_w, t0, t1, st.H, st.W,
                                    et1, grid))
            tiling._derive_window(st, w)
            self.windows.append(w)
            self.pending.append(w)
            self.next_w += 1
            out.append(w)
        return out

    def _advance(self):
        """Fixpoint + emit everything the derive frontier allows."""
        st, grid = self.st, self.grid
        if not self.pending:
            return
        eb_final_hi = self.T if self.eof else self.windows[-1].t1
        fix = [w for w in self.pending if w.et1 <= eb_final_hi]
        if not fix:
            return
        if self.cfg.verify:
            tiling._fixpoint(st, fix, frontier=self.frontier)
        emit_hi = len(fix) if self.eof else len(fix) - 1
        emitted = False
        for w in fix[:emit_hi]:
            for p in tiling._unit_payloads(st, w):
                self.emit(p)
                self._c_emitted.add(1)
            self._c_windows.add(1)
            self.pending.remove(w)
            self.frontier = w.t1
            emitted = True
        if self.pending:
            keep = self.pending[0].t0 - grid.thalo
            drop = [st.u, st.v, st.ufp, st.vfp, st.eb, st.forced]
            if st.ebf is not None:
                drop.append(st.ebf)
            for planes in drop:
                planes.drop_below(keep)
            if emitted and self.checkpoint is not None:
                self.checkpoint(self._snapshot(keep))

    def _snapshot(self, keep: int) -> dict:
        """Everything a resume needs, as one msgpack-able record.

        Only eb/forced planes are snapshotted: u/v/ufp/vfp are re-fed
        (bit-identical) from the source, and preds/seen re-derive.  eb
        planes compress ~50x under zlib-1 (they are mostly the huge
        sentinel); forced planes packbits to H*W/8 bytes."""
        st = self.st
        return {
            "t": "ckpt",
            "frontier": int(self.frontier),
            "resume_from": int(keep),
            "next_w": int(self.pending[0].wi),
            "T": int(self.T),
            "n_units": int(self.n_emitted),
            "eb": [[int(t), zlib.compress(
                np.ascontiguousarray(st.eb.p[t]).tobytes(), 1)]
                for t in sorted(st.eb.p) if t >= keep],
            "forced": [[int(t), np.packbits(st.forced.p[t]).tobytes()]
                       for t in sorted(st.forced.p) if t >= keep],
        }


# ----------------------------------------------------------------------
# journaled session: data file + write-ahead journal + restore
# ----------------------------------------------------------------------

def _fingerprint(cfg, grid, value_range, H, W) -> dict:
    """Everything that must match for resumed bytes to splice cleanly."""
    fp = {k: v for k, v in dataclasses.asdict(cfg).items()
          if isinstance(v, (int, float, str, bool, type(None)))}
    # the scalar filter above silently drops the policy (asdict turns a
    # TilePolicy into a nested dict); it is byte-changing, so a resumed
    # run MUST re-present the identical policy -- record its canonical
    # spec explicitly (_fp_equal's msgpack round trip normalizes tuples)
    fp["eb_policy"] = ebpolicy.policy_spec(
        ebpolicy.normalize(getattr(cfg, "eb_policy", None)))
    # the SL stepper is byte-changing and may come from REPRO_BACKEND
    # rather than cfg.backend: record the one this run writes
    fp["backend"] = backend.resolve(cfg.backend)
    fp["grid"] = dataclasses.asdict(grid)
    fp["value_range"] = [float(value_range[0]), float(value_range[1])]
    fp["H"], fp["W"] = int(H), int(W)
    return fp


def _fp_equal(a: dict, b: dict) -> bool:
    # normalize through one msgpack round trip (tuples -> lists, ...)
    def rt(d):
        return _msgpack.unpackb(_msgpack.packb(d))
    return rt(a) == rt(b)


class _Session:
    """One journaled streaming run against a filesystem-path sink.

    Owns the container data file and the ``<path>.journal`` sidecar,
    wraps unit emission with journal records, performs the
    fsync-ordered checkpoint (data file first, THEN the journal record
    that claims it), and rebuilds writer/plane/index state on resume.
    """

    def __init__(self, path, cfg, grid, value_range, device):
        self.path = os.fspath(path)
        self.device = device
        self.journal_path = self.path + ".journal"
        self.cfg = cfg
        self.grid = grid
        self.value_range = value_range
        self.file = None
        self.journal = None
        self.st = None
        self.resume_from = 0
        self.resumed = False
        self._begin = None
        self._ckpt = None
        self._unit_recs = []
        # per-unit journal records buffered in memory between
        # checkpoints: a record is only durable (or even written) once
        # the checkpoint that claims its bytes lands, so writing them
        # earlier buys no recovery -- units past the last checkpoint
        # are replayed from the source either way.  One batched write +
        # one fsync per window checkpoint instead of a write per unit.
        self._pending_recs = []

    # -- resume inspection -------------------------------------------------
    def finished_stats(self):
        """(None, stats) if the container already has a valid footer
        (the previous run completed); else None."""
        try:
            size = os.path.getsize(self.path)
            with open(self.path, "rb") as f:
                def rd(off, ln):
                    f.seek(off)
                    return f.read(ln)
                hdr, _ = encode.tiled_footer_ranged(rd, size)
        except (OSError, encode.ContainerError):
            return None
        if os.path.exists(self.journal_path):
            os.remove(self.journal_path)
        return None, {
            "already_complete": True,
            "comp_bytes": size,
            "n_units": len(hdr.get("units", ())),
            "pipeline": "tiled",
        }

    def load_journal(self) -> bool:
        """Parse the journal; True if a durable checkpoint exists."""
        try:
            recs = encode.read_journal(self.journal_path)
        except encode.ContainerError:
            return False
        if not recs or recs[0].get("t") != "begin":
            return False
        ckpts = [r for r in recs if r.get("t") == "ckpt"]
        if not ckpts:
            return False
        self._begin = recs[0]
        self._ckpt = ckpts[-1]
        units = [r for r in recs if r.get("t") == "unit"]
        n = int(self._ckpt["n_units"])
        if len(units) < n:
            return False               # journal torn before its ckpt
        self._unit_recs = units[:n]
        self.resume_from = int(self._ckpt["resume_from"])
        return True

    # -- fresh / resumed opening --------------------------------------------
    def open_fresh(self):
        self.file = open(self.path, "wb")
        return self.file

    def begin(self, st, H, W):
        """First-frame hook: the state (and thus the container prologue)
        exists now; start the journal with the run fingerprint."""
        self.st = st
        self.file.flush()
        encode.fsync_timed(self.file.fileno())
        self.journal = encode.JournalWriter(self.journal_path)
        self.journal.append({
            "t": "begin",
            "fp": _fingerprint(self.cfg, self.grid, self.value_range, H, W),
            "H": int(H), "W": int(W),
            "data_start": int(st.writer.bytes_written),
        }, sync=True)

    def restore_state(self):
        """Rebuild compression state from the journal.  Returns the
        restored ``_State`` (caller builds the Scheduler around it)."""
        bg, ck = self._begin, self._ckpt
        fp = _fingerprint(self.cfg, self.grid, self.value_range,
                          bg["H"], bg["W"])
        if not _fp_equal(fp, bg["fp"]):
            raise ResumeError(
                f"journal {self.journal_path} was written by a run with "
                f"different parameters; refusing to splice (delete the "
                f"journal and {self.path} to start over)")
        H, W = int(bg["H"]), int(bg["W"])
        f = open(self.path, "r+b")
        f.truncate(int(ck["bytes"]))
        f.seek(int(ck["bytes"]))
        self.file = f
        # throwaway in-memory writer: only the state scaffolding is
        # wanted; the real writer reattaches to the truncated file
        st = tiling._init_state(self.cfg, self.grid, H, W,
                                self.value_range, None, self.device)
        st.writer = encode.TiledWriter.resumed(
            f, int(ck["bytes"]), [r["entry"] for r in self._unit_recs],
            self.cfg.zstd_level)
        for r in self._unit_recs:
            c = r["counts"]
            st.n_units += 1
            st.n_ll += int(c["ll"])
            st.n_verts += int(c["verts"])
            st.n_sl_blocks += int(c["sl"])
            st.n_blocks += int(c["blocks"])
            if st.tindex is not None and r.get("seg") is not None:
                st.tindex.add_unit(
                    tuple(r["entry"]["key"]),
                    *(encode.unpack_ndarray(d) for d in r["seg"]))
        for t, raw in ck["eb"]:
            st.eb.p[int(t)] = np.frombuffer(
                zlib.decompress(raw), np.int64).reshape(H, W).copy()
        for t, raw in ck["forced"]:
            st.forced.p[int(t)] = np.unpackbits(
                np.frombuffer(raw, np.uint8),
                count=H * W).astype(bool).reshape(H, W)
        self.st = st
        self.resumed = True
        obs.counter("journal.resumes").add(1)
        obs.instant_event("journal.resume",
                          resume_from=int(ck["resume_from"]),
                          n_units=int(ck["n_units"]),
                          bytes=int(ck["bytes"]))
        # rewrite the journal without the (now truncated-away) tail so
        # a crash DURING this resumed run restores consistently; the
        # tmp+rename keeps the swap atomic
        tmp = self.journal_path + ".tmp"
        jw = encode.JournalWriter(tmp)
        jw.append(bg)
        for r in self._unit_recs:
            jw.append(r)
        jw.append(ck, sync=True)
        jw.close()
        os.replace(tmp, self.journal_path)
        self.journal = encode.JournalWriter(self.journal_path, fresh=False)
        return st

    # -- per-unit / per-checkpoint hooks -------------------------------------
    def write_unit(self, p) -> None:
        """Emit one unit AND journal it (directory entry + index rows +
        counters) so a resume can rebuild the writer and sidecar index
        without re-reading container bytes."""
        st = self.st
        tiling._write_unit(st, p)
        bm = np.asarray(p.bm)
        self._pending_recs.append({
            "t": "unit",
            "entry": st.writer.units[-1],
            "counts": {"ll": int(p.ll.sum()), "verts": int(p.ll.size),
                       "sl": int(bm.sum()), "blocks": int(bm.size)},
            "seg": None if p.seg is None else
                   [encode.pack_ndarray(a) for a in p.seg],
        })

    def checkpoint(self, snap: dict) -> None:
        """Durable frontier: the data file is flushed+fsynced BEFORE
        the journal record that claims its byte count, so a checkpoint
        never promises bytes the container does not have.  The buffered
        unit records drain here, ahead of the claiming ckpt record (a
        reader requires every claimed unit record to precede its ckpt),
        and the sync=True on the ckpt append flushes + fsyncs the whole
        batch once."""
        t0 = time.perf_counter_ns()
        with obs.span("journal.checkpoint", units=len(self._pending_recs),
                      frontier=int(snap.get("frontier", -1))):
            snap["bytes"] = int(self.st.writer.bytes_written)
            self.file.flush()
            encode.fsync_timed(self.file.fileno())
            for rec in self._pending_recs:
                self.journal.append(rec)
            self._pending_recs.clear()
            self.journal.append(snap, sync=True)
        obs.counter("journal.checkpoints").add(1)
        if obs.enabled():
            obs.histogram("journal.checkpoint_ns").observe(
                time.perf_counter_ns() - t0)

    # -- teardown -------------------------------------------------------------
    def complete(self):
        """Successful finish: make the container durable, drop the
        journal (it would otherwise shadow the finished footer)."""
        self.file.flush()
        encode.fsync_timed(self.file.fileno())
        self.file.close()
        self.file = None
        if self.journal is not None:
            self.journal.close()
            self.journal = None
        if os.path.exists(self.journal_path):
            os.remove(self.journal_path)

    def abandon(self):
        """Failure path: close handles, KEEP the files -- they are the
        crash artifacts resume works from."""
        for h in (self.file, self.journal):
            try:
                if h is not None:
                    h.close()
            except OSError:
                pass
        self.file = None
        self.journal = None


# ----------------------------------------------------------------------
# entry point
# ----------------------------------------------------------------------

def run(pairs, cfg, grid, value_range, sink=None, async_engine=False,
        resume=False, faults=None, stage_timeout=None, device=None):
    """Streaming-compress ``pairs`` with the serial or async engine.
    Entry point for ``tiling.compress_stream`` (which owns the
    config/grid defaulting and the no-value-range fallback).

    ``pairs`` may be an iterable of (u_t, v_t) or a callable
    ``pairs(t_start) -> iterable`` (lets resume seek the source
    instead of replaying it).  ``sink`` as a filesystem path enables
    the write-ahead journal; ``resume=True`` additionally restores a
    crashed run from it.
    """
    t_start = time.perf_counter()
    journaled = isinstance(sink, (str, os.PathLike))
    if resume and not journaled:
        raise ValueError("resume=True requires a filesystem-path sink "
                         "(the journal lives next to the container)")
    session = None
    if journaled:
        session = _Session(sink, cfg, grid, value_range, device)
        if resume:
            done = session.finished_stats()
            if done is not None:
                done[1]["async_engine"] = bool(async_engine)
                return done
            session.load_journal()

    resume_from = session.resume_from if session else 0
    if callable(pairs):
        src = pairs(resume_from)
    elif resume_from:
        it = iter(pairs)
        for _ in range(resume_from):
            next(it)
        src = it
    else:
        src = pairs

    fpt = faults_mod.FaultPoint(faults)
    timeout = _stage_timeout(stage_timeout)
    try:
        if async_engine:
            blob, stats = _AsyncEngine(
                cfg, grid, value_range, sink, device, session=session,
                faults=fpt, stage_timeout=timeout).run(src, t_start)
        else:
            blob, stats = _run_serial(src, cfg, grid, value_range, sink,
                                      device, t_start, session=session,
                                      faults=fpt)
    except BaseException:
        if session is not None:
            session.abandon()
        raise
    stats["async_engine"] = bool(async_engine)
    stats["resumed_from"] = resume_from
    return blob, stats


def _session_state(session, sched_args):
    """(st, sched) for a journaled run that is resuming, else None."""
    if session is None or session._ckpt is None:
        return None
    st = session.restore_state()
    sched = Scheduler(st, *sched_args, emit=session.write_unit,
                      checkpoint=session.checkpoint)
    sched.restore(session._ckpt)
    return st, sched


def _run_serial(pairs, cfg, grid, value_range, sink, device, t_start,
                session=None, faults=None):
    fpt = faults or faults_mod.FaultPoint(None)
    st = None
    sched = None
    restored = _session_state(session, (cfg, grid))
    if restored is not None:
        st, sched = restored
    for uf, vf in pairs:
        fpt.check("stream.compute")
        uf = np.asarray(uf, np.float32)
        if sched is None:
            H, W = uf.shape
            if session is not None:
                sink = session.open_fresh()
            st = tiling._init_state(cfg, grid, H, W, value_range, sink,
                                    device)
            if session is not None:
                session.begin(st, H, W)
                emit, ckpt = session.write_unit, session.checkpoint
            else:
                emit = lambda p: tiling._write_unit(st, p)  # noqa: E731
                ckpt = None
            sched = Scheduler(st, cfg, grid, emit=emit, checkpoint=ckpt)
        sched.add_frame(uf, vf)
    if sched is None or sched.T < 2:
        raise ValueError("need at least 2 frames")
    sched.finish()
    blob = st.writer.finish(tiling._finish_header(st, sched.T))
    if session is not None:
        session.complete()
    return blob, tiling._stats(st, sched.T, blob, t_start)


_EOF = object()


class _AsyncEngine:
    """Three-stage overlapped engine; see the module docstring.

    Failure containment contract:

    * the FIRST stage failure wins: it is recorded once, both queues
      are poisoned, and the caller's thread re-raises it;
    * no shutdown path ever blocks on a bounded queue: poisoning makes
      room by discarding queued work (the run is already dead);
    * with ``stage_timeout`` set, a stage that stops making progress
      (stuck sink, wedged source) raises EngineStallError instead of
      hanging the caller forever.
    """

    def __init__(self, cfg, grid, value_range, sink, device, session=None,
                 faults=None, stage_timeout=None):
        self.cfg = cfg
        self.grid = grid
        self.value_range = value_range
        self.sink = sink
        self.device = device
        self.session = session
        self.faults = faults or faults_mod.FaultPoint(None)
        self.stage_timeout = stage_timeout
        # queue bounds (cfg.q_in_frames / q_out_units; default one
        # window of frames ahead of the planes, two windows of unit
        # payloads ahead of the writer) change stall behavior only --
        # the scheduler fixes the emission order, hence the bytes
        q_in = cfg.q_in_frames or max(grid.window_t, 2)
        self._q_out_units = cfg.q_out_units
        self.q_in = queue.Queue(maxsize=max(int(q_in), 2))
        self.q_out = None           # sized once the tile count is known
        self.stop = threading.Event()
        self.scale = None           # set after state init; read by ingest
        self._exc = None            # first failing stage's exception
        self._exc_lock = threading.Lock()
        self.st = None

    def _fail(self, e: BaseException) -> None:
        """Record the first failure and wake every stage."""
        with self._exc_lock:
            if self._exc is None:
                self._exc = e
        self.stop.set()

    def _check_failed(self):
        if self._exc is not None:
            raise self._exc

    # ---- ingest stage ---------------------------------------------------

    def _ingest(self, pairs):
        obs.name_thread("engine.ingest")
        try:
            for t, (uf, vf) in enumerate(pairs):
                with obs.span("engine.ingest", t=t):
                    self.faults.check("stream.ingest")
                    uf = np.asarray(uf, np.float32)
                    vf = np.asarray(vf, np.float32)
                    scale = self.scale
                    ufp = vfp = None
                    if scale is not None:
                        # deterministic: bit-equal wherever it is
                        # computed
                        ufp = np.round(uf.astype(np.float64) * scale)
                        vfp = np.round(vf.astype(np.float64) * scale)
                ok = self._put(self.q_in, (uf, vf, ufp, vfp))
                obs.count("engine.frames_ingested", 1)
                if not ok:
                    return
        except BaseException as e:  # propagate to the compute thread
            self._fail(e)
            self._poison(self.q_in)
            return
        # Normal end of input: deliver _EOF in FIFO order behind every
        # queued frame.  _poison would make room by DISCARDING queued
        # frames -- correct when the run is already failing, but on the
        # happy path it would silently drop the tail of the stream.
        try:
            if not self._put(self.q_in, _EOF):
                self._poison(self.q_in)
        except BaseException as e:
            self._fail(e)
            self._poison(self.q_in)

    # ---- writer stage ---------------------------------------------------

    def _writer(self):
        obs.name_thread("engine.writer")
        try:
            while True:
                p = self.q_out.get()
                if obs.enabled():
                    obs.counter_event("engine.q_out",
                                      depth=self.q_out.qsize())
                if p is _EOF:
                    return
                if isinstance(p, tuple) and p[0] == "ckpt":
                    # checkpoint marker: every unit queued before it
                    # has been written, so the byte count is durable
                    self.session.checkpoint(p[1])
                    continue
                with obs.span("engine.write", key=list(p.key)):
                    self.faults.check("stream.write")
                    if self.session is not None:
                        self.session.write_unit(p)
                    else:
                        tiling._write_unit(self.st, p)
                obs.count("engine.units_written", 1)
        except BaseException as e:
            self._fail(e)
            # keep draining so a blocked compute-thread put always
            # completes; poisoned _EOF ends the drain
            while True:
                try:
                    p = self.q_out.get(timeout=0.1)
                except queue.Empty:
                    if self.stop.is_set():
                        return
                    continue
                if p is _EOF:
                    return

    # ---- queue plumbing ---------------------------------------------------

    def _put(self, q, item, force=False):
        """Queue put that stays responsive to shutdown/stage failure.

        Returns False if shutdown/failure interrupted the put (the
        item is dropped -- the run is already failing).  With a
        stage_timeout, a consumer that stops consuming converts the
        wait into EngineStallError instead of an unbounded block."""
        qname = "q_in" if q is self.q_in else "q_out"
        waited = 0.0
        while True:
            try:
                q.put(item, timeout=0.1)
                if waited:
                    # back-pressure stall: this stage sat on a full
                    # queue before the consumer made room
                    obs.count(f"engine.{qname}.stall_ms",
                              int(waited * 1000))
                if obs.enabled():
                    obs.counter_event(f"engine.{qname}", depth=q.qsize())
                return True
            except queue.Full:
                waited += 0.1
                if self._exc is not None:
                    return False
                if not force and self.stop.is_set():
                    return False
                if (self.stage_timeout is not None
                        and waited >= self.stage_timeout):
                    obs.count("engine.watchdog.fired", 1)
                    obs.instant_event("engine.watchdog", queue=qname,
                                      waited_s=round(waited, 1))
                    raise EngineStallError(
                        f"stage consuming {q is self.q_in and 'frames' or 'units'} "
                        f"made no progress for {waited:.1f}s "
                        f"(queue stuck at capacity)")

    @staticmethod
    def _poison(q):
        """Deliver _EOF to a bounded queue WITHOUT ever blocking: if the
        queue is full (consumer dead or slow), discard queued work to
        make room -- by the time a queue is poisoned the run's outcome
        is already decided, so the dropped items are never missed."""
        if q is None:
            return
        while True:
            try:
                q.put_nowait(_EOF)
                return
            except queue.Full:
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass

    def _emit(self, p):
        self._check_failed()
        if not self._put(self.q_out, p):
            self._check_failed()

    def _checkpoint(self, snap):
        # ride the FIFO queue so the writer applies it strictly after
        # the units it covers
        self._check_failed()
        self._put(self.q_out, ("ckpt", snap))

    # ---- compute stage (caller thread) ----------------------------------

    def _get_frame(self):
        """q_in.get with failure fast-path + optional stall watchdog."""
        waited = 0.0
        while True:
            try:
                item = self.q_in.get(timeout=0.1)
                if waited:
                    obs.count("engine.compute.stall_ms",
                              int(waited * 1000))
                return item
            except queue.Empty:
                waited += 0.1
                self._check_failed()
                if (self.stage_timeout is not None
                        and waited >= self.stage_timeout):
                    obs.count("engine.watchdog.fired", 1)
                    obs.instant_event("engine.watchdog", queue="q_in",
                                      waited_s=round(waited, 1))
                    raise EngineStallError(
                        f"ingest produced no frame for {waited:.1f}s "
                        f"(stalled source?)")

    def run(self, pairs, t_start):
        obs.name_thread("engine.compute")
        if self.stage_timeout is not None:
            obs.count("engine.watchdog.armed", 1)
        ingest = threading.Thread(target=self._ingest, args=(pairs,),
                                  name="repro-stream-ingest", daemon=True)
        writer = threading.Thread(target=self._writer,
                                  name="repro-stream-writer", daemon=True)
        session = self.session
        sched = None
        restored = _session_state(session, (self.cfg, self.grid))
        if restored is not None:
            self.st, sched = restored
            # session.write_unit/checkpoint must run on the WRITER
            # thread; rebind the scheduler callbacks to the queue
            sched.emit = self._emit
            sched.checkpoint = self._checkpoint
            self.scale = self.st.scale
            self._size_q_out(self.st.H, self.st.W)
            writer.start()
        ingest.start()
        try:
            while True:
                item = self._get_frame()
                if item is _EOF:
                    break
                uf, vf, ufp, vfp = item
                _csp = obs.span("engine.compute",
                                t=sched.T if sched is not None else 0)
                self.faults.check("stream.compute")
                if sched is None:
                    H, W = uf.shape
                    sink = self.sink
                    if session is not None:
                        sink = session.open_fresh()
                    self.st = tiling._init_state(
                        self.cfg, self.grid, H, W, self.value_range, sink,
                        self.device)
                    if session is not None:
                        session.begin(self.st, H, W)
                    self.scale = self.st.scale
                    self._size_q_out(H, W)
                    writer.start()
                    sched = Scheduler(
                        self.st, self.cfg, self.grid, emit=self._emit,
                        checkpoint=None if session is None
                        else self._checkpoint)
                with _csp:
                    sched.add_frame(uf, vf, ufp, vfp)
                obs.count("engine.frames_computed", 1)
            self._check_failed()
            if sched is None or sched.T < 2:
                raise ValueError("need at least 2 frames")
            sched.finish()
            self._put(self.q_out, _EOF, force=True)
            writer.join(timeout=self.stage_timeout)
            if writer.is_alive():
                raise EngineStallError(
                    f"writer did not drain within {self.stage_timeout}s")
            self._check_failed()
            blob = self.st.writer.finish(
                tiling._finish_header(self.st, sched.T))
            if session is not None:
                session.complete()
            return blob, tiling._stats(self.st, sched.T, blob, t_start)
        except BaseException as e:
            self._fail(e)
            raise
        finally:
            self.stop.set()
            if writer.is_alive():
                self._poison(self.q_out)
                writer.join(timeout=10.0)
            # unblock a full-queue ingest put, then give it a bounded
            # window to exit -- it may be blocked INSIDE the user's
            # frame iterable (a stalled solver/socket), which no amount
            # of draining can interrupt; it is a daemon thread, so
            # leaking it beats hanging the caller on shutdown
            deadline = time.monotonic() + 5.0
            while ingest.is_alive() and time.monotonic() < deadline:
                try:
                    self.q_in.get_nowait()
                except queue.Empty:
                    pass
                ingest.join(timeout=0.1)

    def _size_q_out(self, H, W):
        if self._q_out_units:
            self.q_out = queue.Queue(maxsize=max(int(self._q_out_units), 2))
            return
        nti = -(-H // self.grid.tile_h)
        ntj = -(-W // self.grid.tile_w)
        # ~2 windows of unit payloads in flight, max
        self.q_out = queue.Queue(maxsize=max(2 * nti * ntj, 2))


def resume_info(path) -> dict:
    """What a ``resume=True`` run of ``path`` would do: the journal's
    durable frontier, or completion.  For operators and the recovery
    bench; read-only."""
    path = os.fspath(path)
    out = {"path": path, "complete": False, "resumable": False,
           "resume_from": 0, "n_units": 0, "bytes": 0,
           # per-site transient-retry accounting (faults.retry_stats):
           # a run that survived on retries is distinguishable here
           # from one that never saw an I/O hiccup
           "retries": faults_mod.retry_stats()}
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            def rd(off, ln):
                f.seek(off)
                return f.read(ln)
            hdr, _ = encode.tiled_footer_ranged(rd, size)
        out["complete"] = True
        out["n_units"] = len(hdr.get("units", ()))
        out["bytes"] = size
        return out
    except (OSError, encode.ContainerError):
        pass
    try:
        recs = encode.read_journal(path + ".journal")
    except encode.ContainerError:
        return out
    ckpts = [r for r in recs if r.get("t") == "ckpt"]
    if ckpts:
        out["resumable"] = True
        out["resume_from"] = int(ckpts[-1]["resume_from"])
        out["n_units"] = int(ckpts[-1]["n_units"])
        out["bytes"] = int(ckpts[-1]["bytes"])
    elif recs and recs[0].get("t") == "begin":
        # crashed before the first durable checkpoint: resume restarts
        # the stream from frame 0 (still a valid resume target)
        out["resumable"] = True
    return out
