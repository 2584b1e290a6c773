"""Rate accounting: where do the bytes of a finished container go?

``run_report(container)`` decomposes a container into disjoint byte
ranges by *kind*, summing exactly to the container size, plus the
achieved bits-per-symbol against the Shannon bound of its own symbol
histogram, per unit (the JAX package's ``repro.obs.report`` for CPTZ1,
CPTL1, CPTH1 and CPTT1).

* A CPTH1 (device codec) frame is stored raw, so huffman bitstreams,
  256-entry code-length tables (inside the msgpack section index),
  escape sections and side sections are separable byte ranges.
* A CPTZ1/CPTL1 frame is one zstd/zlib frame; its bytes are reported
  whole under ``unit_frames_compressed`` and the *uncompressed* payload
  split rides along under ``payload_bytes_by_kind`` (it cannot sum to
  the container bytes).

* A CPTT1 (tiled) container adds its magic, the frame preambles, the
  prologue frame and the directory footer to the kinds of its unit
  frames; it needs the preambles of version >= 4.

The Shannon bound is zero-order: ``H(histogram) * n`` bits over the
decoded uint8 symbol streams.
"""
from __future__ import annotations

import struct

import numpy as np

from ..core import _msgpack, encode, entropy

_SYM_SECTIONS = ("sym_u", "sym_v")


def _entropy_bits(sym: np.ndarray) -> float:
    """Zero-order Shannon bound in bits for one uint8 symbol stream."""
    if sym.size == 0:
        return 0.0
    freq = np.bincount(sym.reshape(-1), minlength=256).astype(np.float64)
    p = freq[freq > 0] / float(sym.size)
    return float(-(p * np.log2(p)).sum() * sym.size)


def _device_frame(frame: bytes):
    """Exact kind split + symbol accounting of one raw CPTH1 frame."""
    m = len(encode.MAGIC_HUF)
    (hlen,) = struct.unpack("<I", frame[m: m + 4])
    header = _msgpack.unpackb(frame[m + 4: m + 4 + hlen])
    body = frame[m + 4 + hlen:]
    kinds = {"unit_headers": m + 4 + hlen, "huffman_bitstreams": 0,
             "tables": 0, "escapes": 0, "side_sections": 0}
    n_symbols = 0
    achieved_bits = 0
    shannon_bits = 0.0
    for name, meta in header["sections"].items():
        if meta.get("enc") == "huff":
            kinds["huffman_bitstreams"] += meta["len"]
            table = meta["lengths"]
            kinds["tables"] += len(table)
            kinds["unit_headers"] -= len(table)
            if name in _SYM_SECTIONS:
                n = int(np.prod(meta["shape"], dtype=np.int64))
                raw = body[meta["off"]: meta["off"] + meta["len"]]
                sym = entropy.decode_symbols(
                    np.frombuffer(table, np.uint8), raw, n)
                n_symbols += n
                achieved_bits += 8 * meta["len"]
                shannon_bits += _entropy_bits(sym)
        elif name.startswith("esc_"):
            kinds["escapes"] += meta["len"]
        else:
            kinds["side_sections"] += meta["len"]
    return header, kinds, n_symbols, achieved_bits, shannon_bits


def _host_frame(frame: bytes):
    """Whole-frame kind + payload-level split of one CPTZ1/CPTL1 frame."""
    header, sections = encode.unpack(frame)
    n_symbols = 0
    shannon_bits = 0.0
    payload_kinds = {"symbol_streams": 0, "escapes": 0, "side_sections": 0}
    for name, arr in sections.items():
        nbytes = int(np.asarray(arr).nbytes)
        if name in _SYM_SECTIONS:
            payload_kinds["symbol_streams"] += nbytes
            sym = np.asarray(arr, dtype=np.uint8)
            n_symbols += int(sym.size)
            shannon_bits += _entropy_bits(sym)
        elif name.startswith("esc_"):
            payload_kinds["escapes"] += nbytes
        else:
            payload_kinds["side_sections"] += nbytes
    kinds = {"unit_frames_compressed": len(frame)}
    achieved_bits = 8 * len(frame)
    return (header, kinds, n_symbols, achieved_bits, shannon_bits,
            payload_kinds)


def _merge(dst: dict, src: dict):
    for k, v in src.items():
        dst[k] = dst.get(k, 0) + v


def _unit_row(key, kinds, n_sym, achieved_bits, shannon_bits,
              eb_base=None):
    return {
        "key": list(key) if key is not None else None,
        "n_symbols": int(n_sym),
        "achieved_bits": int(achieved_bits),
        "shannon_bits": round(float(shannon_bits), 1),
        "achieved_bps": round(achieved_bits / max(n_sym, 1), 4),
        "shannon_bps": round(shannon_bits / max(n_sym, 1), 4),
        # the unit's absolute base bound: its frame's own "eb_base"
        # (adaptive policy) or the container's eb_abs
        "eb_base": None if eb_base is None else float(eb_base),
    }


def _report_tiled(blob: bytes) -> dict:
    header, footer_raw = encode.tiled_footer_ranged(
        lambda off, ln: blob[off: off + ln], len(blob))
    frames, _, legacy = encode._scan_frames(blob)
    if legacy:
        raise encode.ContainerError(
            "rate accounting needs v4 frame preambles (pre-v4 archive)")
    m = len(encode.MAGIC_TILED)
    kinds = {
        "magic": m,
        "frame_preambles": encode.PREAMBLE_LEN * len(frames),
        "prologue": 0,
        # zlib(msgpack footer incl. directory + optional track index) +
        # u32 length word + trailing magic
        "directory_footer": len(footer_raw) + 4 + m,
    }
    payload_kinds = {}
    units = []
    codec = None
    for fr in frames:
        frame = blob[fr["off"]: fr["off"] + fr["len"]]
        if fr["mark"] == encode.PROLOGUE_MARK:
            kinds["prologue"] += fr["len"]
            continue
        key = fr["header"].get("key")
        if frame[: len(encode.MAGIC_HUF)] == encode.MAGIC_HUF:
            codec = codec or "device"
            fh, fk, n_sym, ach, sh = _device_frame(frame)
            _merge(kinds, fk)
        else:
            codec = codec or "host"
            fh, fk, n_sym, ach, sh, pk = _host_frame(frame)
            _merge(kinds, fk)
            _merge(payload_kinds, pk)
        units.append(_unit_row(
            key, fk, n_sym, ach, sh,
            eb_base=fh.get("eb_base", header.get("eb_abs"))))
    out = {
        "container": "CPTT1",
        "codec": codec or "host",
        "container_bytes": len(blob),
        "n_units": len(units),
        "bytes_by_kind": kinds,
        "units": units,
    }
    ti = header.get(encode.TRACK_INDEX_KEY)
    if ti is not None:
        out["track_index_bytes_uncompressed"] = len(_msgpack.packb(ti))
    if payload_kinds:
        out["payload_bytes_by_kind"] = payload_kinds
    return out


def _report_monolithic(blob: bytes) -> dict:
    if blob[: len(encode.MAGIC_HUF)] == encode.MAGIC_HUF:
        fh, fk, n_sym, ach, sh = _device_frame(blob)
        codec = "device"
        payload_kinds = None
    else:
        fh, fk, n_sym, ach, sh, payload_kinds = _host_frame(blob)
        codec = "host"
    out = {
        "container": blob[:5].decode("ascii", "replace"),
        "codec": codec,
        "container_bytes": len(blob),
        "n_units": 1,
        "bytes_by_kind": fk,
        "units": [_unit_row(None, fk, n_sym, ach, sh,
                            eb_base=fh.get("eb_abs"))],
    }
    if payload_kinds:
        out["payload_bytes_by_kind"] = payload_kinds
    return out


def run_report(container: bytes) -> dict:
    """Byte-kind decomposition + achieved-vs-Shannon rate.

    ``bytes_by_kind`` values are disjoint container byte ranges and sum
    exactly to ``container_bytes``."""
    blob = bytes(container)
    rep = _report_tiled(blob) if encode.is_tiled(blob) \
        else _report_monolithic(blob)
    rep["kind_bytes_total"] = int(sum(rep["bytes_by_kind"].values()))
    return rep
