"""The containers of the JAX package: monolithic CPTZ1 / CPTL1 / CPTH1
frames and the tiled CPTT1 container of unit frames.

Residual symbols are zigzag-folded and escape-coded into a uint8 stream
(values >= 255 escape to an int64 side list).  A host-codec container is

    magic | codec(u32 header length | msgpack header | raw sections)

with the zstd codec (magic ``CPTZ1``) when the optional ``zstandard``
module is importable, else zlib (magic ``CPTL1``, at most level 6), the
same fallback as the JAX package, so the bytes are equal for equal
sections.  The device-codec container (magic ``CPTH1``, written when a
section is a :class:`HuffSection`) stores the payload raw: symbol
sections are canonical-Huffman bitstreams with their length table in the
section index, the other sections are zlib level 6 each where that
shrinks them.  It uses no zstd, so its bytes do not depend on the host.
The header is written by ``_msgpack`` (byte-equal to
``msgpack.packb(..., use_bin_type=True)``).  Every integrity failure on
the read path raises :class:`ContainerError`.

A tiled container (``TiledWriter``, format versions 4-6) is

    CPTT1 | "CPPR" u32 len u32 crc | prologue frame
          | "CPUN" u32 len u32 crc | unit frame          (repeated)
          | zlib(msgpack footer) | u32 footer length | CPTT1

where every frame is a self-describing monolithic frame and the footer
holds the global decode parameters, the unit directory (key, owned box,
offset, length, CRC32 of each frame) and optionally the track index
under ``TRACK_INDEX_KEY``.  Version-3 containers (no preambles, no
CRCs) read the same way: the reader follows the directory only.  The
preambles make the body walkable without the footer:
``salvage_container`` rebuilds the directory of a truncated or damaged
archive from the prologue and every unit frame whose CRC verifies.

A streaming run into a path keeps a CRC-framed write-ahead journal
beside the container (``JournalWriter`` / ``read_journal``, records
written by ``_msgpack``), and ``TiledWriter.resumed`` reattaches to the
container at the journal's last durable checkpoint.
"""
from __future__ import annotations

import heapq
import io
import os
import struct
import time
import zlib

import numpy as np

from .. import obs
from . import _msgpack

try:
    import zstandard
except ImportError:  # the zlib container is the fallback
    zstandard = None

MAGIC = b"CPTZ1"          # zstd-backed container
MAGIC_ZLIB = b"CPTL1"     # zlib fallback container (same layout inside)
MAGIC_TILED = b"CPTT1"    # tiled container (unit frames + footer)
MAGIC_HUF = b"CPTH1"      # device-entropy container (raw payload)
ESC = 255


class ContainerError(ValueError):
    """Malformed, truncated, or corrupted container bytes."""


class ChecksumError(ContainerError):
    """A unit frame's bytes do not match the CRC of its directory entry
    (bit rot or a torn write)."""


# the footer names the algorithm of the directory's per-unit checksums
CHECKSUM_ALGO = "crc32"


def frame_crc(frame: bytes) -> int:
    """CRC32 of one container frame."""
    return zlib.crc32(frame) & 0xFFFFFFFF


def have_zstd() -> bool:
    return zstandard is not None


def backend_codec() -> str:
    """Name of the container codec pack() will use."""
    return "zstd" if zstandard is not None else "zlib"


def codec_compress(raw: bytes, level: int = 12) -> bytes:
    if zstandard is not None:
        return zstandard.ZstdCompressor(level=level).compress(raw)
    return zlib.compress(raw, min(int(level), 6))


def codec_decompress(blob: bytes, codec: str) -> bytes:
    if codec == "zstd":
        if zstandard is None:
            raise RuntimeError(
                "blob was packed with zstd but the 'zstandard' module is "
                "not installed; pip install zstandard to decode it")
        try:
            return zstandard.ZstdDecompressor().decompress(blob)
        except zstandard.ZstdError as e:
            raise ContainerError(f"corrupt zstd frame: {e}") from e
    if codec == "zlib":
        try:
            return zlib.decompress(blob)
        except zlib.error as e:
            raise ContainerError(f"corrupt zlib frame: {e}") from e
    raise ValueError(
        f"unknown container codec {codec!r}; expected 'zstd' or 'zlib'")


# ----------------------------------------------------------------------
# symbol stream (host numpy)
# ----------------------------------------------------------------------

def fold_np(res):
    res = np.asarray(res, dtype=np.int64)
    return np.where(res >= 0, 2 * res, -2 * res - 1)


def unfold_np(z):
    z = np.asarray(z, dtype=np.int64)
    return np.where(z % 2 == 0, z // 2, -(z + 1) // 2)


def to_symbols(res):
    """int64 residuals -> (uint8 stream, int64 escapes)."""
    res = np.asarray(res, dtype=np.int64)
    z = fold_np(res).reshape(-1)
    esc_mask = z >= ESC
    sym = np.where(esc_mask, ESC, z).astype(np.uint8)
    escapes = res.reshape(-1)[esc_mask].astype(np.int64)
    return sym, escapes


def from_symbols(sym, escapes, shape):
    res = unfold_np(sym.astype(np.int64))
    esc_mask = sym == ESC
    if int(esc_mask.sum()) != len(escapes):
        raise ContainerError(
            f"{int(esc_mask.sum())} escape symbols but {len(escapes)} "
            f"escape values")
    res[esc_mask] = escapes
    return res.reshape(shape)


# ----------------------------------------------------------------------
# field payload sections
# ----------------------------------------------------------------------

def field_sections(res_u, res_v, lossless_np, u_ll, v_ll, bm) -> dict:
    """Symbolize one field payload into the canonical section dict."""
    sym_u, esc_u = to_symbols(res_u)
    sym_v, esc_v = to_symbols(res_v)
    bm = np.asarray(bm)
    return {
        "sym_u": sym_u,
        "sym_v": sym_v,
        "esc_u": esc_u,
        "esc_v": esc_v,
        "lossless": np.packbits(lossless_np),
        "u_ll": np.asarray(u_ll),
        "v_ll": np.asarray(v_ll),
        "blockmap": np.packbits(bm),
        "bm_shape": np.asarray(bm.shape, dtype=np.int32),
    }


def parse_field_sections(sections: dict, shape):
    """Inverse of field_sections (minus the lossless raw values):
    -> (res_u, res_v, blockmap, lossless) host numpy arrays."""
    T, H, W = shape
    try:
        if sections["sym_u"].size != T * H * W \
                or sections["sym_v"].size != T * H * W:
            raise ContainerError("symbol stream length does not match the "
                                 f"shape {list(shape)}")
        res_u = from_symbols(sections["sym_u"], sections["esc_u"], shape)
        res_v = from_symbols(sections["sym_v"], sections["esc_v"], shape)
        bm_shape = tuple(int(x) for x in sections["bm_shape"])
        n_bm = int(np.prod(bm_shape))
        blockmap = np.unpackbits(sections["blockmap"], count=n_bm)
        blockmap = blockmap.astype(bool).reshape(bm_shape)
        lossless = np.unpackbits(sections["lossless"], count=T * H * W)
        lossless = lossless.astype(bool).reshape(shape)
    except KeyError as e:
        raise ContainerError(f"container lacks section {e}") from e
    except ValueError as e:
        if isinstance(e, ContainerError):
            raise
        raise ContainerError(f"corrupt field sections: {e}") from e
    return res_u, res_v, blockmap, lossless


# ----------------------------------------------------------------------
# canonical Huffman (host numpy, bit-exact with the JAX package): the
# reference coder of the rate reporting and of the baselines' accounting
# ----------------------------------------------------------------------

def huffman_code_lengths(freq):
    """Code length per symbol via the standard heap construction."""
    items = [(int(f), i) for i, f in enumerate(freq) if f > 0]
    if not items:
        return np.zeros(len(freq), dtype=np.int32)
    if len(items) == 1:
        ln = np.zeros(len(freq), dtype=np.int32)
        ln[items[0][1]] = 1
        return ln
    heap = [(f, n, (s,)) for n, (f, s) in enumerate(items)]
    heapq.heapify(heap)
    counter = len(heap)
    depth = {}
    while len(heap) > 1:
        f1, _, s1 = heapq.heappop(heap)
        f2, _, s2 = heapq.heappop(heap)
        for s in s1 + s2:
            depth[s] = depth.get(s, 0) + 1
        counter += 1
        heapq.heappush(heap, (f1 + f2, counter, s1 + s2))
    ln = np.zeros(len(freq), dtype=np.int32)
    for s, d in depth.items():
        ln[s] = d
    return ln


def length_limited_lengths(freq, limit: int) -> np.ndarray:
    """Huffman code lengths clamped to ``limit`` bits by halving the
    frequencies until the deepest leaf fits (each pass is a valid tree;
    the loop ends for any limit >= 8 on a 256-symbol alphabet)."""
    freq = np.asarray(freq, dtype=np.int64)
    lengths = huffman_code_lengths(freq)
    while lengths.max() > limit:
        freq = np.where(freq > 0, (freq + 1) // 2, 0)
        lengths = huffman_code_lengths(freq)
    return lengths


def huffman_encode(sym):
    """uint8 symbols -> (lengths table, packed MSB-first bits, n_symbols)."""
    freq = np.bincount(sym, minlength=256)
    lengths = huffman_code_lengths(freq)
    # keep ln + intra-byte offset <= 64 for the vectorized packer
    while lengths.max() > 56:
        freq = np.where(freq > 0, (freq + 1) // 2, 0)
        lengths = huffman_code_lengths(freq)
    codes, _ = canonical_codes(lengths)
    ln = lengths[sym].astype(np.int64)
    cd = codes[sym].astype(np.uint64)
    total = int(ln.sum())
    ends = np.cumsum(ln)
    starts = ends - ln
    nbytes = (total + 7) // 8
    buf = np.zeros(nbytes + 8, dtype=np.uint8)
    # each symbol's code in a 64-bit window at its byte offset, added
    # byte by byte in 8 passes so windows sharing a byte never collide
    byte_off = (starts // 8).astype(np.int64)
    bit_off = (starts % 8).astype(np.int64)
    shift = (64 - bit_off - ln).astype(np.uint64)
    vals = (cd << shift).astype(">u8")
    view = vals.view(np.uint8).reshape(-1, 8)
    for b in range(8):
        np.add.at(buf, byte_off + b, view[:, b])
    return lengths, buf[:nbytes].tobytes(), len(sym)


def huffman_stream_size_bits(sym):
    freq = np.bincount(sym, minlength=256)
    lengths = huffman_code_lengths(freq)
    return int((lengths[sym]).sum())


def canonical_codes(lengths):
    """(codes uint32, lengths) canonical assignment."""
    order = np.lexsort((np.arange(len(lengths)), lengths))
    codes = np.zeros(len(lengths), dtype=np.uint32)
    code = 0
    prev_len = 0
    for s in order:
        ln = int(lengths[s])
        if ln == 0:
            continue
        if prev_len == 0:
            prev_len = ln
        code <<= ln - prev_len
        codes[s] = code
        code += 1
        prev_len = ln
    return codes, lengths


def _peek_tables(lengths, codes, maxlen):
    peek = np.zeros(1 << maxlen, dtype=np.uint16)
    plen = np.zeros(1 << maxlen, dtype=np.uint8)
    for s in np.nonzero(np.asarray(lengths) > 0)[0]:
        ln = int(lengths[s])
        prefix = int(codes[s]) << (maxlen - ln)
        span = 1 << (maxlen - ln)
        peek[prefix: prefix + span] = s
        plen[prefix: prefix + span] = ln
    return peek, plen


def _huffman_decode_scalar(peek, plen, maxlen, data, n):
    """Per-symbol loop for short streams and deep tables."""
    bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8))
    out = np.empty(n, dtype=np.uint8)
    pos = 0
    bits = np.concatenate([bits, np.zeros(maxlen, dtype=np.uint8)])
    pw = (1 << np.arange(maxlen - 1, -1, -1)).astype(np.uint64)
    for i in range(n):
        window = int(bits[pos: pos + maxlen] @ pw)
        out[i] = peek[window]
        pos += int(plen[window])
    return out


# the peek table is capped at 2^24 entries; deeper tables take the
# scalar path
_VEC_MAXLEN = 24
# streams of fewer symbols take the scalar path too, which raises (its
# window slice comes up short) once a symbol starts past the stream's
# last bit; the vectorized path reads the zero padding there instead
SCALAR_BELOW = 2048
_STRIDE_LOG2 = 6


def huffman_decode(lengths, data, n, _chunk=1 << 22):
    """Table-driven canonical Huffman decode, vectorized.

    Stage 1 decodes (symbol, code length) at every bit offset of the
    stream with the canonical peek table, in ``_chunk``-sized blocks.
    Stage 2 resolves the chain of symbol boundaries pos_{i+1} = pos_i +
    len(pos_i) with 2^k-symbol jump tables (k <= 6), a Python walk over
    every 64th boundary and an interleaving expansion back to all n."""
    if n == 0:
        return np.empty(0, dtype=np.uint8)
    codes, _ = canonical_codes(lengths)
    maxlen = int(lengths.max()) if lengths.max() > 0 else 1
    peek, plen = _peek_tables(lengths, codes, maxlen)
    if maxlen > _VEC_MAXLEN or n < SCALAR_BELOW:
        return _huffman_decode_scalar(peek, plen, maxlen, data, n)

    raw = np.frombuffer(data, dtype=np.uint8)
    nbits = 8 * len(raw)
    # 64-bit big-endian rolling windows, one per byte offset
    raw = np.concatenate([raw, np.zeros(16, dtype=np.uint8)])
    nwin = len(raw) - 8
    w64 = np.zeros(nwin, dtype=np.uint64)
    for k in range(8):
        w64 |= raw[k: k + nwin].astype(np.uint64) << np.uint64(56 - 8 * k)

    dom = nbits + maxlen + 1          # padded position domain
    pos_dtype = np.int32 if dom < 2 ** 31 else np.int64
    nxt = np.empty(dom, dtype=pos_dtype)
    sym_at = np.empty(dom, dtype=np.uint8)
    top = np.uint64(64 - maxlen)
    for lo in range(0, dom, _chunk):
        hi = min(lo + _chunk, dom)
        p = np.arange(lo, hi, dtype=np.int64)
        win = (w64[p >> 3] << (p & 7).astype(np.uint64)) >> top
        sym_at[lo:hi] = peek[win]
        nxt[lo:hi] = np.minimum(p + plen[win], dom - 1).astype(pos_dtype)

    L = _STRIDE_LOG2
    J = [nxt]
    for _ in range(L):
        J.append(J[-1][J[-1]])
    n_anchor = -(-n // (1 << L))
    anchors = np.empty(n_anchor, dtype=np.int64)
    jl = J[L]
    pos = 0
    for i in range(n_anchor):
        anchors[i] = pos
        pos = int(jl[pos])
    P = anchors
    for k in range(L - 1, -1, -1):
        Q = np.empty(2 * len(P), dtype=np.int64)
        Q[0::2] = P
        Q[1::2] = J[k][P]
        P = Q
    return sym_at[P[:n]]


# ----------------------------------------------------------------------
# container
# ----------------------------------------------------------------------

class HuffSection:
    """A section whose bytes are already entropy-coded (device codec).

    ``data`` is a canonical-Huffman bitstream over ``n`` uint8 symbols,
    packed MSB-first; ``lengths`` is the 256-entry code-length table
    (uint8, at most ``entropy.L_MAX`` bits), stored in the section index
    so ``unpack`` rebuilds the exact uint8 symbol array."""

    __slots__ = ("data", "lengths", "n")

    def __init__(self, data: bytes, lengths, n: int):
        self.data = bytes(data)
        self.lengths = np.ascontiguousarray(lengths, dtype=np.uint8)
        self.n = int(n)


# small non-symbol sections of a CPTH1 frame get an individual zlib pass;
# below this size the zlib framing is pure overhead
_HUF_ZLIB_MIN = 64


def pack(header: dict, sections: dict, level: int = 12) -> bytes:
    """Assemble one container frame: CPTH1 when a section is a
    ``HuffSection``, else CPTZ1 / CPTL1."""
    if any(isinstance(a, HuffSection) for a in sections.values()):
        return _pack_huf(header, sections)
    body = io.BytesIO()
    sec_index = {}
    for name, arr in sections.items():
        raw = np.ascontiguousarray(arr).tobytes()
        sec_index[name] = {
            "off": body.tell(),
            "len": len(raw),
            "dtype": str(arr.dtype),
            "shape": list(arr.shape),
        }
        body.write(raw)
    header = dict(header)
    header["sections"] = sec_index
    header["codec"] = backend_codec()
    hdr = _msgpack.packb(header)
    payload = struct.pack("<I", len(hdr)) + hdr + body.getvalue()
    magic = MAGIC if zstandard is not None else MAGIC_ZLIB
    return magic + codec_compress(payload, level)


def _pack_huf(header: dict, sections: dict) -> bytes:
    body = io.BytesIO()
    sec_index = {}
    for name, arr in sections.items():
        if isinstance(arr, HuffSection):
            sec_index[name] = {
                "off": body.tell(),
                "len": len(arr.data),
                "dtype": "uint8",
                "shape": [arr.n],
                "enc": "huff",
                "lengths": arr.lengths.tobytes(),
            }
            body.write(arr.data)
            continue
        raw = np.ascontiguousarray(arr).tobytes()
        meta = {
            "off": body.tell(),
            "len": len(raw),
            "dtype": str(arr.dtype),
            "shape": list(arr.shape),
        }
        if len(raw) >= _HUF_ZLIB_MIN:
            comp = zlib.compress(raw, 6)
            if len(comp) < len(raw):
                meta["len"] = len(comp)
                meta["enc"] = "zlib"
                raw = comp
        sec_index[name] = meta
        body.write(raw)
    header = dict(header)
    header["sections"] = sec_index
    header["codec"] = "huffman"
    hdr = _msgpack.packb(header)
    return MAGIC_HUF + struct.pack("<I", len(hdr)) + hdr + body.getvalue()


def _decode_section(name: str, meta: dict, raw: bytes,
                    device=None) -> np.ndarray:
    """One section's bytes -> array, honoring its per-section ``enc``; a
    Huffman section decodes on ``device`` (``entropy.decode_symbols``)."""
    enc = meta.get("enc")
    try:
        dtype, shape = meta["dtype"], meta["shape"]
        if enc == "huff":
            lengths = np.frombuffer(meta["lengths"], np.uint8)
            if lengths.size != 256:
                raise ContainerError(
                    f"section {name!r}: huffman table has {lengths.size} "
                    f"entries, expected 256")
            n = int(np.prod(shape, dtype=np.int64))
            from . import entropy
            arr = entropy.decode_symbols(lengths, raw, n, device)
        elif enc == "zlib":
            arr = np.frombuffer(zlib.decompress(raw), dtype=np.dtype(dtype))
        elif enc is None:
            arr = np.frombuffer(raw, dtype=np.dtype(dtype))
        else:
            raise ContainerError(
                f"section {name!r}: unknown encoding {enc!r}")
        return arr.reshape(shape)
    except ContainerError:
        raise
    except (TypeError, ValueError, zlib.error) as e:
        raise ContainerError(f"corrupt section {name!r}: {e}") from e


def unpack(blob: bytes, device=None):
    """Container bytes -> (header dict, {name: numpy array}).  A CPTH1
    container's Huffman sections decode on ``device`` (default: the
    host)."""
    with obs.span("decode.unpack", bytes=len(blob)):
        magic = bytes(blob[: len(MAGIC)])
        if magic == MAGIC_TILED:
            raise ContainerError(
                "CPTT1 is a tiled container of unit frames: read it with "
                "repro_torch.decompress (core/tiling.py::decompress_tiled) "
                "or tiled_header / read_tiled_unit")
        if magic == MAGIC_HUF:
            return _parse_payload(bytes(blob[len(MAGIC_HUF):]), device)
        if magic not in (MAGIC, MAGIC_ZLIB):
            raise ContainerError(
                "not a CPTZ/CPTL/CPTH container (bad magic)")
        codec = "zstd" if magic == MAGIC else "zlib"
        return _parse_payload(codec_decompress(bytes(blob[len(MAGIC):]),
                                               codec))


def _parse_payload(payload: bytes, device=None):
    if len(payload) < 4:
        raise ContainerError("truncated container: missing header length")
    (hlen,) = struct.unpack("<I", payload[:4])
    if 4 + hlen > len(payload):
        raise ContainerError(
            f"truncated container: header length {hlen} exceeds "
            f"{len(payload)}-byte payload")
    try:
        header = _msgpack.unpackb(payload[4: 4 + hlen])
    except (ValueError, UnicodeDecodeError) as e:
        raise ContainerError(f"corrupt container header: {e}") from e
    if not isinstance(header, dict) or "sections" not in header:
        raise ContainerError("container header has no sections index")
    base = 4 + hlen
    sections = {}
    sec_index = header.pop("sections")
    if not isinstance(sec_index, dict):
        raise ContainerError("container sections index is not a map")
    for name, meta in sec_index.items():
        try:
            off, ln = meta["off"], meta["len"]
        except (TypeError, KeyError) as e:
            raise ContainerError(
                f"malformed section entry {name!r}: {e}") from e
        if not (isinstance(off, int) and isinstance(ln, int)):
            raise ContainerError(
                f"malformed section entry {name!r}: non-integer "
                f"off/len {off!r}/{ln!r}")
        lo = base + off
        hi = lo + ln
        if off < 0 or ln < 0 or hi > len(payload):
            raise ContainerError(
                f"section {name!r} byte range [{lo}, {hi}) outside "
                f"{len(payload)}-byte payload")
        if "dtype" not in meta or "shape" not in meta:
            raise ContainerError(
                f"malformed section entry {name!r}: missing dtype/shape")
        sections[name] = _decode_section(name, meta, payload[lo:hi],
                                         device)
    return header, sections


# ----------------------------------------------------------------------
# tiled container (CPTT1)
# ----------------------------------------------------------------------

TRACK_INDEX_KEY = "track_index"

UNIT_MARK = b"CPUN"       # per-unit frame preamble mark (version >= 4)
PROLOGUE_MARK = b"CPPR"   # prologue frame preamble mark (version >= 4)
_PREAMBLE = struct.Struct("<II")          # (frame_len, frame_crc)
PREAMBLE_LEN = len(UNIT_MARK) + _PREAMBLE.size


def _preamble(mark: bytes, frame: bytes) -> bytes:
    return mark + _PREAMBLE.pack(len(frame), frame_crc(frame))


def pack_ndarray(arr) -> dict:
    """msgpack-able {dtype, shape, data} triple of a numpy array."""
    arr = np.ascontiguousarray(arr)
    return {"dtype": str(arr.dtype), "shape": [int(s) for s in arr.shape],
            "data": arr.tobytes()}


def unpack_ndarray(d: dict) -> np.ndarray:
    return np.frombuffer(d["data"], dtype=np.dtype(d["dtype"])).reshape(
        d["shape"])


def is_tiled(blob: bytes) -> bool:
    return bytes(blob[: len(MAGIC_TILED)]) == MAGIC_TILED


class TiledWriter:
    """Append-only tiled-container writer.  Writes to ``sink`` (anything
    with ``write``) or, with ``sink=None``, to a buffer whose bytes
    ``finish`` returns.  Units are written as they arrive."""

    def __init__(self, sink=None, level: int = 12, prologue: dict = None):
        self._own = sink is None
        self._sink = io.BytesIO() if sink is None else sink
        self._level = level
        self._sink.write(MAGIC_TILED)
        self._pos = len(MAGIC_TILED)
        self.units = []
        if prologue is not None:
            frame = pack(dict(prologue), {}, self._level)
            self._sink.write(_preamble(PROLOGUE_MARK, frame))
            self._sink.write(frame)
            self._pos += PREAMBLE_LEN + len(frame)

    @classmethod
    def resumed(cls, sink, pos: int, units: list,
                level: int = 12) -> "TiledWriter":
        """Reattach to a partially written container (crash resume).
        ``sink`` is already positioned at byte ``pos`` (the file truncated
        to the journal's durable frontier); ``units`` is the directory
        recovered from the journal.  Writes nothing: the next
        ``add_unit`` appends where the interrupted run would have."""
        w = cls.__new__(cls)
        w._own = False
        w._sink = sink
        w._level = level
        w._pos = int(pos)
        w.units = [dict(u) for u in units]
        return w

    def add_unit(self, key, box, header: dict, sections: dict) -> None:
        """Append one (window, tile) unit and its directory entry.  key:
        (wi, ti, tj); box: the half-open owned (t0, t1, i0, i1, j0, j1)."""
        header = dict(header)
        header["key"] = [int(k) for k in key]
        frame = pack(header, sections, self._level)
        self._sink.write(_preamble(UNIT_MARK, frame))
        self._pos += PREAMBLE_LEN
        self.units.append({
            "key": [int(k) for k in key],
            "box": [int(b) for b in box],
            "off": self._pos,
            "len": len(frame),
            "crc": frame_crc(frame),
        })
        self._sink.write(frame)
        self._pos += len(frame)

    def finish(self, header: dict):
        """Write the directory footer; returns the blob when buffering."""
        header = dict(header)
        header["units"] = self.units
        header.setdefault("checksum", CHECKSUM_ALGO)
        hdr = zlib.compress(_msgpack.packb(header), 6)
        self._sink.write(hdr)
        self._sink.write(struct.pack("<I", len(hdr)))
        self._sink.write(MAGIC_TILED)
        self._pos += len(hdr) + 4 + len(MAGIC_TILED)
        return self._sink.getvalue() if self._own else None

    @property
    def bytes_written(self) -> int:
        return self._pos


def tiled_footer_ranged(read, size: int):
    """(footer dict, compressed footer bytes) through a range reader
    ``read(off, ln) -> bytes`` over a container of ``size`` bytes."""
    m = len(MAGIC_TILED)
    if size < 2 * m + 4:
        raise ContainerError(
            f"truncated tiled container: {size} bytes is smaller than "
            f"the minimal frame")
    if read(0, m) != MAGIC_TILED:
        raise ContainerError("not a CPTT tiled container (bad magic)")
    tail = read(size - m - 4, m + 4)
    if tail[-m:] != MAGIC_TILED:
        raise ContainerError("truncated tiled container (no footer)")
    (hlen,) = struct.unpack("<I", tail[:4])
    if hlen + 2 * m + 4 > size:
        raise ContainerError(
            f"corrupt tiled footer: header length {hlen} exceeds "
            f"{size}-byte container")
    raw = read(size - m - 4 - hlen, hlen)
    try:
        header = _msgpack.unpackb(zlib.decompress(raw))
    except (ValueError, UnicodeDecodeError, zlib.error) as e:
        raise ContainerError(f"corrupt tiled footer: {e}") from e
    if not isinstance(header, dict) or "units" not in header:
        raise ContainerError("tiled footer has no unit directory")
    units = header["units"]
    if not isinstance(units, list) or any(
            not isinstance(e, dict)
            or not {"key", "box", "off", "len"} <= e.keys()
            for e in units):
        raise ContainerError("tiled footer unit directory is malformed")
    for e in units:
        off, ln = e["off"], e["len"]
        if not (isinstance(off, int) and isinstance(ln, int)
                and m <= off and 0 <= ln and off + ln <= size):
            raise ContainerError(
                f"unit directory entry {e['key']} byte range "
                f"[{off}, {off + ln}) outside [{m}, {size})")
    return header, raw


def tiled_header_ranged(read, size: int) -> dict:
    """Directory footer through an (offset, length) range reader."""
    return tiled_footer_ranged(read, size)[0]


def tiled_header(blob: bytes) -> dict:
    """Directory footer of a tiled container (header dict with units)."""
    return tiled_header_ranged(lambda off, ln: blob[off: off + ln],
                               len(blob))


def check_unit_frame(frame: bytes, entry: dict) -> None:
    """Raise ChecksumError unless ``frame`` matches its entry's CRC (no
    check for pre-v4 entries, which carry none)."""
    want = entry.get("crc")
    if want is None:
        return
    got = frame_crc(frame)
    if got != int(want):
        raise ChecksumError(
            f"unit {entry.get('key')} checksum mismatch: stored "
            f"{int(want):#010x}, frame bytes hash to {got:#010x} "
            f"(bit rot or torn write)")


def read_tiled_unit_ranged(read, entry: dict, device=None):
    """Decode one unit frame through a range reader (its Huffman sections
    on ``device``, default the host)."""
    frame = read(entry["off"], entry["len"])
    if len(frame) != entry["len"]:
        raise ContainerError(
            f"short read: unit frame at [{entry['off']}, "
            f"{entry['off'] + entry['len']}) returned {len(frame)} bytes "
            f"(truncated container?)")
    check_unit_frame(frame, entry)
    return unpack(frame, device)


def read_tiled_unit(blob: bytes, entry: dict):
    """Decode one unit frame by directory entry (reads only its bytes)."""
    return read_tiled_unit_ranged(lambda off, ln: blob[off: off + ln],
                                  entry)


def _scan_frames(data: bytes):
    """Walk the frame preambles of a version >= 4 body.  Returns
    (frames, n_dropped, legacy): one dict {"mark", "off", "len", "crc",
    "header"} per frame whose CRC matches and whose header parses,
    resynchronizing on the unit mark across damaged spans; legacy is
    True when the body has no preamble at all (version <= 3)."""
    m = len(MAGIC_TILED)
    frames, n_dropped = [], 0
    pos = m
    if data[pos: pos + len(PROLOGUE_MARK)] not in (PROLOGUE_MARK, UNIT_MARK):
        return frames, n_dropped, True
    while True:
        mark = data[pos: pos + 4]
        if mark not in (PROLOGUE_MARK, UNIT_MARK):
            nxt = data.find(UNIT_MARK, pos + 1)
            if nxt < 0:
                break
            n_dropped += 1
            pos = nxt
            continue
        body = pos + PREAMBLE_LEN
        if body > len(data):
            break                      # torn preamble at the end
        ln, crc = _PREAMBLE.unpack(data[pos + 4: body])
        frame = data[body: body + ln]
        ok = len(frame) == ln and frame_crc(frame) == crc
        header = None
        if ok:
            try:
                header, _ = unpack(frame)
            except ContainerError:
                ok = False             # a mark inside a payload
        if not ok:
            nxt = data.find(UNIT_MARK, pos + 1)
            if nxt < 0:
                break
            n_dropped += 1
            pos = nxt
            continue
        frames.append({"mark": bytes(mark), "off": body, "len": ln,
                       "crc": crc, "header": header})
        pos = body + ln
    return frames, n_dropped, False


def salvage_container(data, out=None, fallback_header: dict = None):
    """Rebuild a readable tiled container from a damaged archive.

    ``data`` is the bytes (or a path) of a tiled container whose footer
    is missing or corrupt or whose body has damaged spans.  The body is
    walked by its frame preambles; every unit whose CRC verifies is
    copied into a fresh container under a footer synthesized from the
    prologue frame's global parameters (or ``fallback_header`` when the
    prologue itself is lost).  Returns ``(blob, report)``; with ``out``
    (a path) the blob is written there and ``blob`` is None.  Version <=
    3 archives have no preambles to walk and raise ContainerError."""
    if isinstance(data, (str, bytes)) and not isinstance(data, bytes):
        with open(data, "rb") as f:
            data = f.read()
    if data[: len(MAGIC_TILED)] != MAGIC_TILED:
        raise ContainerError("not a CPTT tiled container (bad magic)")
    frames, n_dropped, legacy = _scan_frames(data)
    if legacy:
        raise ContainerError(
            "archive has no v4 frame preambles (pre-v4 container); "
            "nothing to walk -- salvage needs the footer, which is "
            "the only directory a version<=3 archive has")
    prologue = None
    prologue_found = False
    units = []
    for fr in frames:
        if fr["mark"] == PROLOGUE_MARK:
            if prologue is None:
                prologue = fr["header"]
                prologue_found = True
            continue
        hdr = fr["header"]
        if "key" not in hdr or "box" not in hdr:
            n_dropped += 1
            continue
        units.append(fr)
    if prologue is None:
        if fallback_header is None:
            raise ContainerError(
                "prologue frame unrecoverable and no fallback_header "
                "given; cannot synthesize decode parameters")
        prologue = dict(fallback_header)
    header = {k: v for k, v in prologue.items() if k != "prologue"}
    shape = list(header.get("shape", [0, 0, 0]))
    if units:
        shape[0] = max(int(fr["header"]["box"][1]) for fr in units)
    header["shape"] = shape
    header["salvaged"] = True
    header.setdefault("checksum", CHECKSUM_ALGO)

    buf = io.BytesIO()
    buf.write(MAGIC_TILED)
    pframe = pack(dict(prologue), {})
    buf.write(_preamble(PROLOGUE_MARK, pframe))
    buf.write(pframe)
    directory = []
    for fr in sorted(units, key=lambda f: tuple(f["header"]["key"])):
        frame = data[fr["off"]: fr["off"] + fr["len"]]
        buf.write(_preamble(UNIT_MARK, frame))
        directory.append({
            "key": [int(k) for k in fr["header"]["key"]],
            "box": [int(b) for b in fr["header"]["box"]],
            "off": buf.tell(),
            "len": fr["len"],
            "crc": fr["crc"],
        })
        buf.write(frame)
    header["units"] = directory
    raw = zlib.compress(_msgpack.packb(header), 6)
    buf.write(raw)
    buf.write(struct.pack("<I", len(raw)))
    buf.write(MAGIC_TILED)
    blob = buf.getvalue()
    report = {
        "units_recovered": len(directory),
        "units_dropped": n_dropped,
        "bytes_scanned": len(data),
        "bytes_recovered": len(blob),
        "prologue_recovered": prologue_found,
    }
    if out is not None:
        with open(out, "wb") as f:
            f.write(blob)
        return None, report
    return blob, report


# ----------------------------------------------------------------------
# write-ahead journal (sidecar of a streaming compression run)
# ----------------------------------------------------------------------
#
# ``<container>.journal`` is an append-only file of length- and
# CRC-framed msgpack records:
#
#     "CPTJ1" | u32 len | u32 crc | msgpack(record) | ...
#
# record["t"]: "begin" (run fingerprint + data_start), "unit" (one
# emitted unit: directory entry, index rows, counters) and "ckpt" (a
# durable frontier: container byte count, scheduler counters, the
# eb/forced planes of every still-resident frame).  A crash can tear at
# most the last record; the reader stops at the first length/CRC
# mismatch.  The data file is fsynced before the "ckpt" record that
# claims its bytes is appended and fsynced.

JOURNAL_MAGIC = b"CPTJ1"


def fsync_timed(fileno: int) -> None:
    """``os.fsync`` counted (``journal.fsync``) and, with tracing on,
    timed (``journal.fsync_ns``): every durability point of the stream
    path goes through here."""
    obs.counter("journal.fsync").add(1)
    if obs.enabled():
        t0 = time.perf_counter_ns()
        os.fsync(fileno)
        obs.histogram("journal.fsync_ns").observe(
            time.perf_counter_ns() - t0)
    else:
        os.fsync(fileno)


class JournalWriter:
    """Append-only, CRC-framed journal of a crash-recoverable stream."""

    def __init__(self, path: str, fresh: bool = True):
        self.path = path
        self._f = open(path, "wb" if fresh else "ab")
        if fresh:
            self._f.write(JOURNAL_MAGIC)
            self._f.flush()

    def append(self, record: dict, sync: bool = False) -> None:
        raw = _msgpack.packb(record)
        self._f.write(struct.pack("<II", len(raw), frame_crc(raw)))
        self._f.write(raw)
        if sync:
            self._f.flush()
            fsync_timed(self._f.fileno())

    def close(self) -> None:
        self._f.flush()
        self._f.close()


def read_journal(path: str):
    """Every intact record of a journal ([] when it is absent or empty);
    a torn tail ends the scan.  ContainerError only when the file is not
    a journal at all (bad magic)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return []
    if not data:
        return []
    if data[: len(JOURNAL_MAGIC)] != JOURNAL_MAGIC:
        raise ContainerError(f"{path}: not a CPTJ1 journal")
    records = []
    pos = len(JOURNAL_MAGIC)
    while pos + 8 <= len(data):
        ln, crc = struct.unpack("<II", data[pos: pos + 8])
        raw = data[pos + 8: pos + 8 + ln]
        if len(raw) != ln or frame_crc(raw) != crc:
            break                      # torn tail: stop at the last intact
        try:
            records.append(_msgpack.unpackb(raw))
        except (ValueError, UnicodeDecodeError):
            break
        pos += 8 + ln
    return records
