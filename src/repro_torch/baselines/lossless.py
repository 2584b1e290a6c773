"""Lossless baselines (paper Tables II-V upper-bound rows), host only.

gzip / zstd are the real codecs (zstd falls back to zlib without the
``zstandard`` module, as the containers do); "fpzip-like" approximates
FPZIP's float-stream decorrelation with byte-plane splitting +
per-plane delta + the container codec, and is labelled "-like"
everywhere it is reported.
"""
from __future__ import annotations

import time
import zlib

import numpy as np

from ..core import encode as _enc


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _raw(u, v) -> bytes:
    return np.ascontiguousarray(u).tobytes() + np.ascontiguousarray(v).tobytes()


def gzip_compress(u, v, **kw):
    raw = _raw(u, v)
    blob, tc = _timed(lambda: zlib.compress(raw, 6))
    dec, td = _timed(lambda: zlib.decompress(blob))
    if dec != raw:
        raise RuntimeError("gzip baseline did not round-trip")
    n = len(raw)
    return {
        "name": "gzip", "lossless": True,
        "orig_bytes": n, "comp_bytes": len(blob),
        "ratio": n / len(blob), "t_compress": tc, "t_decompress": td,
        "u_rec": u, "v_rec": v,
    }


def zstd_compress(u, v, level=12, **kw):
    raw = _raw(u, v)
    blob, tc = _timed(lambda: _enc.codec_compress(raw, level))
    codec = _enc.backend_codec()
    dec, td = _timed(lambda: _enc.codec_decompress(blob, codec))
    if dec != raw:
        raise RuntimeError(f"{codec} baseline did not round-trip")
    n = len(raw)
    return {
        "name": codec, "lossless": True,
        "orig_bytes": n, "comp_bytes": len(blob),
        "ratio": n / len(blob), "t_compress": tc, "t_decompress": td,
        "u_rec": u, "v_rec": v,
    }


def _byteplane(arr: np.ndarray) -> bytes:
    """Byte-plane split + per-plane delta (fpzip-flavoured decorrelation)."""
    b = np.ascontiguousarray(arr).view(np.uint8).reshape(-1, arr.dtype.itemsize)
    planes = [np.diff(b[:, i].astype(np.int16), prepend=np.int16(0))
              .astype(np.int8) for i in range(arr.dtype.itemsize)]
    return np.concatenate(planes).tobytes()


def _unbyteplane(raw: bytes, shape, dtype) -> np.ndarray:
    n = int(np.prod(shape))
    item = np.dtype(dtype).itemsize
    planes = np.frombuffer(raw, np.int8).reshape(item, n)
    b = np.empty((n, item), np.uint8)
    for i in range(item):
        b[:, i] = np.cumsum(planes[i].astype(np.int16)).astype(np.uint8)
    return b.reshape(-1).view(dtype)[:n].reshape(shape)


def fpzip_like(u, v, level=12, **kw):
    raw_u = _byteplane(u)
    raw_v = _byteplane(v)
    blob, tc = _timed(lambda: (_enc.codec_compress(raw_u, level),
                               _enc.codec_compress(raw_v, level)))
    codec = _enc.backend_codec()

    def dec():
        ur = _unbyteplane(_enc.codec_decompress(blob[0], codec), u.shape,
                          u.dtype)
        vr = _unbyteplane(_enc.codec_decompress(blob[1], codec), v.shape,
                          v.dtype)
        return ur, vr

    (ur, vr), td = _timed(dec)
    if not ((ur == u).all() and (vr == v).all()):
        raise RuntimeError("fpzip-like baseline did not round-trip")
    n = u.nbytes + v.nbytes
    total = len(blob[0]) + len(blob[1])
    return {
        "name": "fpzip-like", "lossless": True,
        "orig_bytes": n, "comp_bytes": total,
        "ratio": n / total, "t_compress": tc, "t_decompress": td,
        "u_rec": u, "v_rec": v,
    }
