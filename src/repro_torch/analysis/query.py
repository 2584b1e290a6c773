"""Range reads of a tiled container (the JAX package's
``analysis.query.ContainerSource`` and ``fetch_decoded_units``, without
fault injection, retries, the read thread pool and the decoded-unit
cache; track queries are ROADMAP Queue 1 item 9)."""
from __future__ import annotations

import os

from .. import obs
from ..core import encode


class ContainerSource:
    """(offset, length) reads over container bytes or a file path.

    A path keeps one descriptor for the source's lifetime and reads with
    ``os.pread``; every read is length-checked (a short read raises
    ContainerError).  ``reads`` / ``bytes_fetched`` count the reads this
    source issued (the process totals are the obs counters
    ``query.range_reads`` / ``query.bytes_fetched``)."""

    def __init__(self, src):
        if isinstance(src, (bytes, bytearray, memoryview)):
            self._blob = bytes(src)
            self._fd = None
            self.size = len(self._blob)
        else:
            self._blob = None
            self._fd = os.open(os.fspath(src), os.O_RDONLY)
            self.size = os.fstat(self._fd).st_size
        self.reads = 0
        self.bytes_fetched = 0
        self._hdr = None

    def read(self, off: int, ln: int) -> bytes:
        if self._blob is not None:
            data = self._blob[off: off + ln]
        else:
            if self._fd is None:
                raise ValueError("source is closed")
            # a pread may return fewer bytes than asked before the end
            parts, got = [], 0
            while got < ln:
                chunk = os.pread(self._fd, ln - got, off + got)
                if not chunk:
                    break
                parts.append(chunk)
                got += len(chunk)
            data = b"".join(parts)
        if len(data) != ln:
            raise encode.ContainerError(
                f"short read: [{off}, {off + ln}) of a {self.size}-byte "
                f"container returned {len(data)} bytes")
        self.reads += 1
        self.bytes_fetched += len(data)
        obs.counter("query.range_reads").add(1)
        obs.counter("query.bytes_fetched").add(len(data))
        return data

    def header(self) -> dict:
        """The directory footer, read once per source (three reads)."""
        if self._hdr is None:
            self._hdr = encode.tiled_footer_ranged(self.read, self.size)[0]
        return self._hdr

    def unit(self, entry: dict):
        """(unit header, sections) of one directory entry (one read)."""
        return encode.read_tiled_unit_ranged(self.read, entry)

    def close(self):
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def fetch_decoded_units(source: ContainerSource, ex, entries: list):
    """Decoded ``(box, u_rec, v_rec)`` patches of the directory entries,
    in entry order: one checksum-verified read and one decode a unit."""
    obs.count("query.units_decoded", len(entries))
    out = []
    for e in entries:
        uh, secs = source.unit(e)
        u_rec, v_rec = ex.decode_unit(uh, secs)
        out.append((tuple(uh["box"]), u_rec, v_rec))
    return out
