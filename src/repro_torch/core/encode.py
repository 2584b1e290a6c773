"""The monolithic host container (the JAX package's CPTZ1 / CPTL1 format).

Residual symbols are zigzag-folded and escape-coded into a uint8 stream
(values >= 255 escape to an int64 side list).  A container is

    magic | codec(u32 header length | msgpack header | raw sections)

with the zstd codec (magic ``CPTZ1``) when the optional ``zstandard``
module is importable, else zlib (magic ``CPTL1``, at most level 6), the
same fallback as the JAX package, so the bytes are equal for equal
sections.  The header is written by ``_msgpack`` (byte-equal to
``msgpack.packb(..., use_bin_type=True)``).  Every integrity failure on
the read path raises :class:`ContainerError`.
"""
from __future__ import annotations

import io
import struct
import zlib

import numpy as np

from . import _msgpack

try:
    import zstandard
except ImportError:  # the zlib container is the fallback
    zstandard = None

MAGIC = b"CPTZ1"          # zstd-backed container
MAGIC_ZLIB = b"CPTL1"     # zlib fallback container (same layout inside)
MAGIC_TILED = b"CPTT1"    # tiled container (not ported)
MAGIC_HUF = b"CPTH1"      # device-entropy container (not ported)
ESC = 255


class ContainerError(ValueError):
    """Malformed, truncated, or corrupted container bytes."""


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
# container
# ----------------------------------------------------------------------

def pack(header: dict, sections: dict, level: int = 12) -> bytes:
    """Assemble one CPTZ1 / CPTL1 container frame."""
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


def _decode_section(name: str, meta: dict, raw: bytes) -> np.ndarray:
    if meta.get("enc") is not None:
        raise ContainerError(
            f"section {name!r}: unknown encoding {meta.get('enc')!r}")
    try:
        arr = np.frombuffer(raw, dtype=np.dtype(meta["dtype"]))
        return arr.reshape(meta["shape"])
    except (TypeError, ValueError) as e:
        raise ContainerError(f"corrupt section {name!r}: {e}") from e


def unpack(blob: bytes):
    """Container bytes -> (header dict, {name: numpy array})."""
    magic = bytes(blob[: len(MAGIC)])
    if magic in (MAGIC_TILED, MAGIC_HUF):
        raise NotImplementedError(
            f"{magic.decode()} containers are not ported to repro_torch "
            "yet (ROADMAP Queue 1 items 6-7)")
    if magic not in (MAGIC, MAGIC_ZLIB):
        raise ContainerError("not a CPTZ/CPTL container (bad magic)")
    codec = "zstd" if magic == MAGIC else "zlib"
    return _parse_payload(codec_decompress(bytes(blob[len(MAGIC):]), codec))


def _parse_payload(payload: bytes):
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
        sections[name] = _decode_section(name, meta, payload[lo:hi])
    return header, sections
