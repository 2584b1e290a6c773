"""Feature-directed queries against a CPTT1 container's track index (the
JAX package's ``analysis/query.py``).

``query_tracks`` filters the sidecar track summaries (no unit decode at
all -- only the footer is parsed); ``track_read_plan`` turns one track
into the exact set of directory entries its reconstruction needs; and
``decode_for_track`` byte-slices and decodes ONLY those covering units,
re-deriving the track's polyline from the decoded values.

All entry points accept either raw container bytes or a filesystem
path; ``decode_for_track`` decodes on the CUDA device unless
``device="cpu"`` is passed.  Path sources are accessed with seek-based RANGE READS (footer +
covering unit frames only), so the "touches only the covering units"
property holds for the actual file I/O, not just the decode work.

Why the partial decode is exact: the sidecar stores the track's
*topology* (global face ids of its crossing nodes, segment edges, tet
anchor cells) but not its geometry.  Geometry is recomputed at query
time from the decoded field, gathering only grid points inside the
covering units (index.py's inflation argument guarantees every gather
-- barycentric node solve and classification Jacobian cell -- lands
there).  Units decode bit-identically whether decoded alone or as part
of the full field, so the polyline equals what full-decode extraction
would produce, node for node, bit for bit.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import time
from collections import OrderedDict

from typing import Optional

import numpy as np

import torch

from .. import obs
from ..core import backend as backend_mod, compressor, encode, fixedpoint
from ..core import faults as faults_mod
from . import classify as classify_mod
from . import extraction, model
from . import index as index_mod
from .index import TrackIndex, parse_track_index


class ContainerSource:
    """(offset, length) range reads over bytes or a file path.

    Path sources keep ONE file descriptor for the source's lifetime and
    read with ``os.pread`` -- positional, so concurrent range reads from
    the fetch pool never race on a shared seek offset (the previous
    implementation reopened the file on every call and silently
    truncated short reads).  Every read is length-checked: a truncated
    container raises ContainerError instead of decoding garbage.

    ``retries``/``backoff`` give TRANSIENT I/O errors (flaky NFS,
    interrupted reads -- raised as OSError) a bounded number of
    re-attempts with exponential backoff before the error escapes;
    ContainerError (corrupt bytes) is never retried -- re-reading
    cannot un-corrupt a frame.  ``faults`` accepts a core.faults
    FaultPlan probed at site ``"source.read"`` on every raw read.

    ``reads``/``bytes_fetched`` count the range reads actually issued --
    the observable the decoded-unit cache is benchmarked and tested
    against; ``retried`` counts recovered transient failures.  All
    three are views over per-source obs child counters, so one
    ``obs.snapshot()`` also sees the process-wide totals under
    ``query.range_reads`` / ``query.bytes_fetched`` / ``query.retried``.
    """

    def __init__(self, src, faults=None, retries: int = 0,
                 backoff: float = 0.01):
        if isinstance(src, (bytes, bytearray, memoryview)):
            self._blob = bytes(src)
            self._fd = None
            self._path = None
            self.size = len(self._blob)
        else:
            self._blob = None
            self._path = os.fspath(src)
            self._fd = os.open(self._path, os.O_RDONLY)
            self.size = os.fstat(self._fd).st_size
        self._c_reads = obs.child_counter("query.range_reads")
        self._c_bytes = obs.child_counter("query.bytes_fetched")
        self._c_retried = obs.child_counter("query.retried")
        self.retries = int(retries)
        self.backoff = float(backoff)
        self.faults = faults_mod.FaultPoint(faults)
        self._lock = threading.Lock()
        self._hdr = None
        self._container_id = None

    @property
    def reads(self) -> int:
        return self._c_reads.value

    @property
    def bytes_fetched(self) -> int:
        return self._c_bytes.value

    @property
    def retried(self) -> int:
        return self._c_retried.value

    def _read_once(self, off: int, ln: int) -> bytes:
        self.faults.check("source.read")
        t0 = time.perf_counter_ns() if obs.enabled() else 0
        if self._blob is not None:
            data = self._blob[off : off + ln]
        else:
            if self._fd is None:
                raise ValueError("source is closed")
            # POSIX allows a single pread to return fewer bytes than
            # asked without being at EOF (signals, NFS, the ~2 GiB
            # per-call cap); only a 0-byte read means truncation
            parts = []
            got = 0
            while got < ln:
                chunk = os.pread(self._fd, ln - got, off + got)
                if not chunk:
                    break
                parts.append(chunk)
                got += len(chunk)
            data = b"".join(parts)
        if t0:
            obs.observe("query.pread_ns", time.perf_counter_ns() - t0)
        if len(data) != ln:
            raise encode.ContainerError(
                f"short read: [{off}, {off + ln}) of a {self.size}-byte "
                f"container returned {len(data)} bytes")
        self._c_reads.add(1)
        self._c_bytes.add(len(data))
        return data

    def read(self, off: int, ln: int) -> bytes:
        def _note(attempt, exc):
            self._c_retried.add(1)
        return faults_mod.retry_transient(
            lambda: self._read_once(off, ln), retries=self.retries,
            backoff=self.backoff, on_retry=_note, site="source.read")

    def read_many(self, entries: list, failures: list = None) -> list:
        """Concurrent range reads for a list of directory entries.
        Bytes sources read serially -- a memory slice has no I/O
        latency to hide, so pool handoff would be pure overhead.

        Worker exceptions ALWAYS surface: every future is awaited and
        the first failure re-raises on the caller's thread (typed --
        a truncated frame arrives as ContainerError, an I/O fault as
        OSError).  With ``failures`` given (degraded mode), per-entry
        errors are appended as ``(entry, exc)`` and the result list
        carries None at the failed positions instead of raising."""
        def one(e):
            try:
                return self.read(e["off"], e["len"])
            except (encode.ContainerError, OSError) as exc:
                if failures is None:
                    raise
                with self._lock:
                    failures.append((e, exc))
                return None
        if len(entries) <= 1 or self._blob is not None:
            return [one(e) for e in entries]
        from ..parallel.sharding import host_map, host_pool

        return host_map(host_pool("range-read"), one, entries)

    def close(self):
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # best-effort; explicit close preferred
        try:
            self.close()
        except Exception:
            pass

    def header(self) -> dict:
        """Directory footer (parsed once per source; three range reads).

        Also derives ``container_id`` -- a content fingerprint of the
        compressed footer bytes -- so the decoded-unit cache recognizes
        the same container across repeated queries regardless of
        whether it arrives as a path or as bytes."""
        if self._hdr is None:
            hdr, raw = encode.tiled_footer_ranged(self.read, self.size)
            self._hdr = hdr
            self._container_id = (self.size,
                                  hashlib.sha1(raw).hexdigest())
        return self._hdr

    @property
    def container_id(self):
        if self._container_id is None:
            self.header()
        return self._container_id

    def unit(self, entry: dict, device=None):
        return encode.read_tiled_unit_ranged(self.read, entry, device)


# ----------------------------------------------------------------------
# bounded LRU cache of DECODED units
# ----------------------------------------------------------------------

class UnitCache:
    """Byte-bounded LRU of decoded unit patches.

    Keyed by ``(container_id, unit_off, SL stepper)``; values are the
    decoded float32 ``(box, u_rec, v_rec)`` host numpy patches, which
    every read path (region decode, track decode) derives its output
    from -- unit decode is deterministic and bit-identical on every
    device, so a cached patch is exactly what a fresh decode with that
    stepper would produce (the steppers part on clamped substeps, so a
    decode's ``backend=`` is part of the key), and the cache holds no
    device memory.  Bounded
    by total payload bytes, not entry count, so one capacity knob works
    for any tile geometry.  Thread-safe: served reads may overlap.
    """

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self._d: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.cur_bytes = 0
        # hit/miss/eviction accounting lives in obs child counters (the
        # process totals appear in obs.snapshot() as cache.hits /
        # cache.misses / cache.evicted_bytes); the public fields below
        # are views over them
        self._c_hits = obs.child_counter("cache.hits")
        self._c_misses = obs.child_counter("cache.misses")
        self._c_evicted = obs.child_counter("cache.evicted_bytes")

    @property
    def hits(self) -> int:
        return self._c_hits.value

    @property
    def misses(self) -> int:
        return self._c_misses.value

    def get(self, key):
        with self._lock:
            val = self._d.get(key)
            if val is None:
                self._c_misses.add(1)
                return None
            self._d.move_to_end(key)
            self._c_hits.add(1)
            return val

    def put(self, key, value):
        box, u_rec, v_rec = value
        cost = int(u_rec.nbytes + v_rec.nbytes)
        with self._lock:
            if self.max_bytes <= 0 or cost > self.max_bytes:
                return
            old = self._d.pop(key, None)
            if old is not None:
                self.cur_bytes -= int(old[1].nbytes + old[2].nbytes)
            self._d[key] = value
            self.cur_bytes += cost
            while self.cur_bytes > self.max_bytes:
                _, (_, u_old, v_old) = self._d.popitem(last=False)
                dropped = int(u_old.nbytes + v_old.nbytes)
                self.cur_bytes -= dropped
                self._c_evicted.add(dropped)
        obs.gauge_set("cache.bytes", self.cur_bytes)

    def clear(self):
        with self._lock:
            self._d.clear()
            self.cur_bytes = 0
            self._c_hits.set_local(0)
            self._c_misses.set_local(0)
        obs.gauge_set("cache.bytes", 0)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._d), "bytes": self.cur_bytes,
                    "max_bytes": self.max_bytes, "hits": self.hits,
                    "misses": self.misses}


def _cache_mb_from_env() -> float:
    raw = os.environ.get("REPRO_UNIT_CACHE_MB", "")
    try:
        return float(raw) if raw else 256.0
    except ValueError:
        import warnings

        warnings.warn(f"ignoring malformed REPRO_UNIT_CACHE_MB={raw!r}; "
                      f"using the 256 MiB default")
        return 256.0


unit_cache = UnitCache(int(_cache_mb_from_env() * 2**20))


def configure_unit_cache(max_mb: float) -> UnitCache:
    """Resize (and clear) the process-wide decoded-unit cache.
    ``max_mb=0`` disables caching.  Initial size comes from the
    ``REPRO_UNIT_CACHE_MB`` environment variable (default 256)."""
    unit_cache.clear()
    unit_cache.max_bytes = int(max_mb * 2**20)
    return unit_cache


def fetch_decoded_units(source: ContainerSource, ex, entries: list,
                        failures: list = None):
    """Decoded ``(box, u_rec, v_rec)`` patches for directory entries,
    served from the unit cache; missing unit frames are range-read
    CONCURRENTLY, checksum-verified, decoded once through the shared
    executor, and cached.  Returns (patches in entry order, cache hit
    count).

    With ``failures`` given (degraded mode), units that fail the range
    read, the CRC check, or decode are appended as ``(entry, exc)`` and
    SKIPPED -- the patch list then holds only the surviving units, in
    entry order.  Without it, the first damaged unit raises."""
    cid = source.container_id
    tag = ex.plan.sl_backend
    out = {}
    missing = []
    for e in entries:
        got = unit_cache.get((cid, e["off"], tag))
        if got is None:
            missing.append(e)
        else:
            out[e["off"]] = got
    n_hits = len(entries) - len(missing)
    if missing:
        obs.count("query.units_decoded", len(missing))
        frames = source.read_many(missing, failures=failures)
        for e, frame in zip(missing, frames):
            if frame is None:       # read failed (already in failures)
                continue
            try:
                encode.check_unit_frame(frame, e)
                uh, secs = encode.unpack(frame, ex.device)
                u_rec, v_rec = ex.decode_unit(uh, secs)
            except encode.ContainerError as exc:
                if failures is None:
                    raise
                failures.append((e, exc))
                continue
            val = (tuple(uh["box"]), u_rec, v_rec)
            unit_cache.put((cid, e["off"], tag), val)
            out[e["off"]] = val
    return [out[e["off"]] for e in entries if e["off"] in out], n_hits


def load_track_index(src):
    """(source, footer header, TrackIndex) of a tiled container.

    ``src`` is raw bytes or a path; only the footer is read here.
    """
    source = ContainerSource(src)
    hdr = source.header()
    return source, hdr, parse_track_index(hdr)


def _summary(idx: TrackIndex, k: int) -> dict:
    hist = idx.track_type_hist[k]
    return {
        "track_id": int(k),
        "t_min": float(idx.track_t_min[k]),
        "t_max": float(idx.track_t_max[k]),
        "bbox": [float(x) for x in idx.track_bbox[k]],  # y0, y1, x0, x1
        "n_nodes": int(idx.track_n_nodes[k]),
        "n_segments": int(idx.track_seg_counts[k]),
        "type_hist": {name: int(hist[i])
                      for i, name in enumerate(model.CP_TYPES) if hist[i]},
        "dominant_type": model.CP_TYPES[int(np.argmax(hist))],
        "n_cover_units": int(idx.track_cover_ptr[k + 1]
                             - idx.track_cover_ptr[k]),
    }


def track_summaries(src) -> list:
    """All track summaries of a container (footer parse only)."""
    source, _, idx = load_track_index(src)
    with source:
        return [_summary(idx, k) for k in range(idx.n_tracks)]


def query_tracks(src, bbox=None, trange=None, cp_type=None) -> list:
    """Tracks matching the given feature filters (footer parse only).

    bbox:   (y_min, y_max, x_min, x_max) grid coordinates; a track
            matches when its node bounding box overlaps.
    trange: (t_min, t_max); overlap test on the track lifetime.
    cp_type: a model.CP_TYPES name; matches tracks containing at least
            one node of that type.

    Summaries reflect the pre-compression field; the verify loop makes
    its crossed-face topology identical to the decoded field's, and
    node positions move by O(eb) only, so the filters are exact in
    topology and eb-accurate in geometry.
    """
    source, _, idx = load_track_index(src)
    source.close()
    sel = np.ones(idx.n_tracks, dtype=bool)
    if trange is not None:
        t0, t1 = float(trange[0]), float(trange[1])
        sel &= (idx.track_t_max >= t0) & (idx.track_t_min <= t1)
    if bbox is not None:
        y0, y1, x0, x1 = (float(b) for b in bbox)
        sel &= (idx.track_bbox[:, 1] >= y0) & (idx.track_bbox[:, 0] <= y1)
        sel &= (idx.track_bbox[:, 3] >= x0) & (idx.track_bbox[:, 2] <= x1)
    if cp_type is not None:
        if cp_type not in model.CP_CODE:
            raise ValueError(
                f"unknown cp_type {cp_type!r}; expected one of "
                f"{model.CP_TYPES}")
        sel &= idx.track_type_hist[:, model.CP_CODE[cp_type]] > 0
    return [_summary(idx, int(k)) for k in np.nonzero(sel)[0]]


def _cover_entries(hdr: dict, idx: TrackIndex, track_id: int) -> list:
    """Directory entries of the units covering one track."""
    wi, ti, tj = idx.decode_keys(idx.cover_units(track_id))
    keys = {(int(a), int(b), int(c)) for a, b, c in zip(wi, ti, tj)}
    return [e for e in hdr["units"] if tuple(e["key"]) in keys]


def track_read_plan(src, track_id: int) -> list:
    """Directory entries a ``decode_for_track`` would read -- and
    nothing else (byte offsets + lengths for remote range reads)."""
    source, hdr, idx = load_track_index(src)
    source.close()
    return _cover_entries(hdr, idx, track_id)


class _PatchField:
    """Fancy-indexing facade over a set of decoded unit boxes."""

    def __init__(self, shape, patches):
        self.shape = shape
        self.patches = patches            # [(box, int64 array)]

    def __getitem__(self, idx):
        t, i, j = (np.asarray(x) for x in idx)
        t, i, j = np.broadcast_arrays(t, i, j)
        out = np.zeros(t.shape, dtype=np.int64)
        found = np.zeros(t.shape, dtype=bool)
        for (t0, t1, i0, i1, j0, j1), arr in self.patches:
            m = ((t >= t0) & (t < t1) & (i >= i0) & (i < i1)
                 & (j >= j0) & (j < j1) & ~found)
            if m.any():
                out[m] = arr[t[m] - t0, i[m] - i0, j[m] - j0]
                found |= m
        if not found.all():
            raise encode.ContainerError(
                "track gather landed outside the covering units -- "
                "corrupt or incompatible track index")
        return out


@dataclasses.dataclass(frozen=True)
class TrackDecode:
    """decode_for_track result: the exact polyline + read accounting.

    ``bytes_read`` is the LOGICAL read volume of the plan (sum of
    covering-unit frame lengths -- what a cold decode costs);
    ``range_reads``/``bytes_fetched`` count the range reads actually
    issued this call, and shrink to the three footer reads when every
    covering unit is served from the decoded-unit cache.

    Degraded decodes (``degraded=True`` over a damaged container)
    additionally report what was lost: ``missing_units`` lists the
    covering units that failed to read or verify, ``segments_dropped``
    counts track segments whose reconstruction would have gathered
    into a missing unit, and ``pieces`` holds the surviving connected
    sub-polylines; ``track`` is then the largest piece (or None when
    nothing survives).
    """

    track: Optional[model.Track]
    units_read: int
    units_total: int
    bytes_read: int
    entries: list
    range_reads: int = 0
    bytes_fetched: int = 0
    cache_hits: int = 0
    missing_units: list = dataclasses.field(default_factory=list)
    segments_dropped: int = 0
    pieces: tuple = ()

    @property
    def complete(self) -> bool:
        return not self.missing_units


def _segment_survivors(seg_cell, missing_boxes, shape):
    """Keep mask over segments whose gather footprint avoids every
    missing unit's owned box.

    The footprint is the same +2-clamped point cover the track index
    uses to compute covering units (index._cover_points) -- so a kept
    segment's node position and Jacobian classification gather ONLY
    points owned by units that decoded, and are bit-identical to a
    full, undamaged decode of that segment.
    """
    pts = index_mod._cover_points(seg_cell, shape)        # (S, P, 3)
    bad = np.zeros(pts.shape[:2], dtype=bool)
    for t0, t1, i0, i1, j0, j1 in missing_boxes:
        bad |= ((pts[..., 0] >= t0) & (pts[..., 0] < t1)
                & (pts[..., 1] >= i0) & (pts[..., 1] < i1)
                & (pts[..., 2] >= j0) & (pts[..., 2] < j1))
    return ~bad.any(axis=1)


def decode_for_track(src, track_id: int, backend=None,
                     degraded: bool = False, *, device=None) -> TrackDecode:
    """Decode ONLY the units covering ``track_id`` and rebuild its
    polyline exactly (bit-identical to full-decode extraction).  Unit
    decode goes through the shared pipeline executor -- the same
    decode_payload implementation full decode and region decode use --
    and repeated or overlapping queries are served from the
    decoded-unit cache instead of re-reading and re-decoding.

    ``degraded=True``: units that fail to read or checksum-verify are
    reported in ``missing_units`` instead of raising, segments that
    would gather into them are dropped, and the surviving connected
    sub-polylines come back in ``pieces`` (assembled through the same
    build_tracks path, so each piece is exact on the points it keeps).
    Structural damage -- an unreadable footer -- still raises; run
    ``encode.salvage_container`` first for that.

    ``backend`` names the SL stepper of the unit decodes in place of the
    footer's (``core.tiling.decompress_tiled``).
    """
    from ..core import pipeline as pipeline_mod

    dev = compressor.resolve_device(device)
    compressor.refuse_plain_on_card(backend, dev)
    source, hdr, idx = load_track_index(src)
    with obs.span("query.decode_for_track",
                  track_id=int(track_id)) as sp, source:
        idx._check(track_id)
        T, H, W = hdr["shape"]
        entries = _cover_entries(hdr, idx, track_id)
        ex = pipeline_mod.executor_from_header(hdr, dev, backend)
        failures = [] if degraded else None
        decoded, n_hits = fetch_decoded_units(source, ex, entries,
                                              failures=failures)
        patches_u, patches_v = [], []
        for box, u_rec, v_rec in decoded:
            ufp, vfp = fixedpoint.refix(u_rec, v_rec, hdr["scale"])
            patches_u.append((box, ufp))
            patches_v.append((box, vfp))
        up = _PatchField((T, H, W), patches_u)
        vp = _PatchField((T, H, W), patches_v)

        seg_fid, seg_cell = idx.track_segments(track_id)
        n_dropped = 0
        if failures:
            keep = _segment_survivors(
                seg_cell, [tuple(e["box"]) for e, _ in failures],
                (T, H, W))
            n_dropped = int(len(seg_fid) - keep.sum())
            seg_fid = seg_fid[keep]
        missing = [{"key": tuple(e["key"]), "box": tuple(e["box"]),
                    "error": str(err)} for e, err in (failures or ())]
        acct = dict(
            units_read=len(entries) - len(missing),
            units_total=len(hdr["units"]),
            bytes_read=int(sum(e["len"] for e in entries)),
            entries=entries,
            range_reads=source.reads,
            bytes_fetched=source.bytes_fetched,
            cache_hits=n_hits,
            missing_units=missing,
            segments_dropped=n_dropped,
        )
        sp.set(units=len(entries), cache_hits=n_hits,
               range_reads=source.reads,
               bytes_fetched=source.bytes_fetched)
        if len(seg_fid) == 0:
            return TrackDecode(track=None, **acct)
        node_fid = np.unique(seg_fid)
        local_edges = np.searchsorted(node_fid, seg_fid).astype(np.int64)
        pos = extraction.node_positions(node_fid, up, vp, (T, H, W))
        types = classify_mod.classify_nodes(up, vp, pos,
                                            spiral_tol=idx.spiral_tol)
        if n_dropped == 0:
            # single-component assembly through the same code path as
            # full extraction, so ordering / loop detection can never
            # diverge
            (track,) = model.build_tracks(
                pos, node_fid, types,
                np.zeros(len(node_fid), dtype=np.int32), local_edges)
            return TrackDecode(
                track=dataclasses.replace(track, track_id=track_id),
                **acct)
        # dropped segments can split the survivors into several
        # connected pieces; label them and assemble each one
        labels = backend_mod.connected_labels(
            len(node_fid), torch.as_tensor(local_edges)).numpy()
        track_of = extraction.dense_track_ids(node_fid, labels)
        pieces = model.build_tracks(pos, node_fid, types,
                                    track_of, local_edges)
        pieces = tuple(sorted(pieces, key=lambda p: -len(p.face_ids)))
        return TrackDecode(
            track=dataclasses.replace(pieces[0], track_id=track_id),
            pieces=pieces, **acct)
