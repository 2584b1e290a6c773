"""The device entropy codec (``codec="device"``, the CPTH1 container).

The host codec (encode.py) fetches the residual streams and symbolizes
and compresses them on the host.  This codec entropy-codes them on the
device the residuals already live on, for a (B, n) stack of rows (the u
and v streams of a field are two rows):

  1. **symbolize** (torch ops): zigzag-fold the int64 residual rows,
     clamp to the ESC escape symbol, count a per-row 256-bin histogram
     (``backend.symbol_histogram``: K5 on CUDA), and compact each row's
     escaped residuals in row order.
  2. **code build** (host numpy): per-row canonical code tables from the
     histograms, length-limited to ``L_MAX`` bits, for the whole batch at
     once (``build_tables_batch``).  The (B, 256) counts are the only
     data that crosses to the host before packing.
  3. **bitpack** (torch ops): gather each symbol's (length, code), take
     every symbol's bit offset by a prefix sum, and scatter-add the
     MSB-first code windows into a byte buffer in 3 byte-lane passes.

Each row's table depends only on that row's counts, so batched and
sequential encodes give the same bytes, and every step is integer-exact,
so the bytes do not depend on the device and equal the JAX package's
(its ``entropy.encode_streams``).  The length table rides in the section
index (encode.HuffSection).  ``decode_symbols`` replays a stream on the
device the decode runs on: with none or the CPU through the host
``encode.huffman_decode``, on CUDA through K6 (``backend.huffman_decode``),
which gives the host decode's symbols, or its error, on every input.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import obs
from . import backend
from .encode import (ESC, SCALAR_BELOW, ContainerError, HuffSection,
                     canonical_codes, huffman_decode)

L_MAX = 16           # code length limit (static worst-case pack buffer)


# ----------------------------------------------------------------------
# host side: table build + decode
# ----------------------------------------------------------------------

def build_tables_batch(hist) -> tuple[np.ndarray, np.ndarray]:
    """(R, 256) counts -> (lengths int32 (R, 256), codes uint32 (R, 256)).

    Shannon-style lengths ``ceil(log2(n/count))`` clamped to
    ``[1, L_MAX]``: Kraft-valid by construction (each 2^-len <= p) and
    within one bit per symbol of optimal; a row whose clamp breaks Kraft
    (> 2^L_MAX-fold skew) falls back to flat 8-bit codes.  The code words
    are the canonical assignment of those lengths (as
    ``encode.canonical_codes``), vectorized over rows."""
    hist = np.asarray(hist, np.int64)
    R = hist.shape[0]
    present = hist > 0
    n = hist.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore"):
        ln = np.ceil(np.log2(np.maximum(n, 1)
                             / np.maximum(hist, 1))).astype(np.int32)
    ln = np.where(present, np.clip(ln, 1, L_MAX), 0)
    kraft = np.where(present, np.int64(1) << (L_MAX - ln), 0).sum(axis=1)
    bad = kraft > (np.int64(1) << L_MAX)
    if bad.any():
        ln[bad] = np.where(present[bad], 8, 0)
    # canonical assignment: first code of length l = (first of l-1 +
    # count of l-1) << 1, and same-length symbols take codes in symbol
    # order
    onehot = ln[:, :, None] == np.arange(1, L_MAX + 1, dtype=np.int32)
    csum = np.cumsum(onehot, axis=1, dtype=np.int16)     # (R, 256, L_MAX)
    cnt = csum[:, -1, :].astype(np.int64)                # (R, L_MAX)
    first = np.zeros((R, L_MAX + 1), np.int64)           # first[l] for len l
    for l in range(2, L_MAX + 1):
        first[:, l] = (first[:, l - 1] + cnt[:, l - 2]) << 1
    rank_s = np.take_along_axis(
        csum - 1, np.maximum(ln - 1, 0)[:, :, None], axis=2)[:, :, 0]
    codes = np.take_along_axis(first, ln.astype(np.int64), axis=1) + rank_s
    codes = np.where(present, codes, 0)
    return ln, codes.astype(np.uint32)


def decode_symbols(lengths, data, n, device=None) -> np.ndarray:
    """Inverse of the bitpack: lengths uint8[256] (from the section index)
    + packed bits -> n uint8 symbols, on the host.  The table checks run
    on the host first; with a CUDA ``device`` the stream is decoded there
    (``decode_on``), else by the host ``huffman_decode``."""
    dev = torch.device("cpu" if device is None else device)
    with obs.span("decode.huffman", symbols=n, device=str(dev)):
        if n == 0:
            return np.empty(0, dtype=np.uint8)
        ln = np.asarray(lengths, np.uint8).astype(np.int32)
        ml = int(ln.max())
        if ml == 0 or ml > L_MAX:
            raise ContainerError(
                f"invalid huffman table: max code length {ml} "
                f"(expected 1..{L_MAX})")
        # Kraft inequality: a corrupt table would overflow the peek tables
        kraft = int((np.int64(1) << (ml - ln[ln > 0])).sum())
        if kraft > (1 << ml):
            raise ContainerError(
                "invalid huffman table: Kraft sum exceeds 1")
        if dev.type == "cpu":
            return huffman_decode(ln, data, n)
        obs.count("decode.huffman_card", 1)
        return decode_on(dev, ln, data, n)


def decode_on(dev, ln, data, n) -> np.ndarray:
    """One section's decode on ``dev`` (K6 on CUDA, its plain version on
    the CPU) held to the host ``huffman_decode``: the symbols come back
    as a host array, and the host decode's ContainerError is raised
    where it would raise."""
    codes, _ = canonical_codes(ln)
    sym, total, past = backend.huffman_decode(ln, codes, data, n, dev)
    # below SCALAR_BELOW symbols the host decode takes its scalar path,
    # whose window slice fails once a symbol starts past the stream's
    # last bit: a chain that ended `past` bits beyond it starts symbol
    # total + 1 there, inside the stream only where past == 0
    if (n < SCALAR_BELOW and past is not None and n > total
            and not (past == 0 and n == total + 1)):
        raise ContainerError(
            f"huffman stream of {8 * len(data)} bits ends after {total} "
            f"of {n} symbols")
    return sym.cpu().numpy()


# ----------------------------------------------------------------------
# device side: symbolize + bitpack (torch ops on the rows' device)
# ----------------------------------------------------------------------

def _pack_cap(n: int) -> int:
    # worst-case packed bytes per row, plus the 8-byte scatter skirt
    return (n * L_MAX) // 8 + 8


def symbolize(rows: torch.Tensor):
    """(B, n) int64 residuals -> (sym uint8 (B, n), hist int32 (B, 256),
    escapes int64 (every row's escaped residuals, row after row, each in
    row order), n_esc int64 (B,))."""
    z = torch.where(rows >= 0, 2 * rows, -2 * rows - 1)
    esc = z >= ESC
    sym = torch.where(esc, ESC, z).to(torch.uint8)
    hist = backend.symbol_histogram(sym)
    return sym, hist, torch.masked_select(rows, esc), esc.sum(dim=1)


def bitpack(sym: torch.Tensor, lengths: np.ndarray, codes: np.ndarray):
    """(B, n) uint8 symbols + per-row host tables -> (buf uint8 (B, cap),
    nbits int64 (B,)), the arithmetic of the JAX package's
    ``entropy._bitpack_np``.  With L_MAX + 7 <= 23 a code sits in bits
    9..31 of a 32-bit MSB-first window at its byte offset, so three
    big-endian byte lanes carry it.  The lanes of different symbols that
    land on one byte hold disjoint bits, so their int32 sums stay <= 255
    and the cast to uint8 is exact."""
    B, n = sym.shape
    cap = _pack_cap(n)
    dev = sym.device
    # codes are < 2^L_MAX and lengths <= L_MAX, so one LUT (length in the
    # high half) serves both gathers
    lut = torch.as_tensor(((lengths.astype(np.int64) << 16)
                           | codes.astype(np.int64)).reshape(-1), device=dev)
    rows = torch.arange(B, dtype=torch.int64, device=dev)[:, None]
    g = lut[sym.to(torch.int64) + (rows << 8)]
    ln = g >> 16
    ends = torch.cumsum(ln, dim=1)
    starts = ends - ln
    vals = (g & 0xFFFF) << (32 - (starts & 7) - ln)
    off = ((starts >> 3) + rows * cap).reshape(-1)
    out = torch.zeros(B * cap, dtype=torch.int32, device=dev)
    for b in range(3):     # lane 3 (bits 0..7) is zero: shift >= 9
        lane = ((vals >> (24 - 8 * b)) & 0xFF).to(torch.int32).reshape(-1)
        out.scatter_add_(0, off + b, lane)
    return out.to(torch.uint8).reshape(B, cap), ends[:, -1]


# ----------------------------------------------------------------------
# entry points
# ----------------------------------------------------------------------

def encode_streams(res_u, res_v) -> list[dict]:
    """Entropy-code (B, ...) residual stacks (tensors on one device, or
    numpy arrays, which stay on the CPU).

    The u and v streams go as 2B rows through one symbolize and one
    bitpack; returns one section fragment per unit, ``{"sym_u":
    HuffSection, "sym_v": ..., "esc_u": int64[...], "esc_v": ...}``, for
    the same keys of ``encode.field_sections``."""
    res_u = torch.as_tensor(res_u)
    res_v = torch.as_tensor(res_v, device=res_u.device)
    with obs.span("entropy.encode_streams", units=int(res_u.shape[0]),
                  device=str(res_u.device)):
        # the fetches to the host inside are the device syncs: the span
        # closes only after the bitstreams landed
        return _encode_streams(res_u, res_v)


def _encode_streams(res_u, res_v) -> list[dict]:
    B = int(res_u.shape[0])
    n = int(res_u[0].numel())
    rows = torch.cat([res_u.reshape(B, n),
                      res_v.reshape(B, n)]).to(torch.int64)
    sym, hist, escapes, n_esc = symbolize(rows)
    lengths, codes = build_tables_batch(hist.cpu().numpy())
    buf, nbits = bitpack(sym, lengths, codes)
    nbytes = ((nbits + 7) // 8).cpu().numpy()
    esc_at = np.concatenate([[0], np.cumsum(n_esc.cpu().numpy())])
    escapes = escapes.cpu().numpy()
    lengths_u8 = lengths.astype(np.uint8)

    def stream(i):
        return HuffSection(buf[i, : int(nbytes[i])].cpu().numpy().tobytes(),
                           lengths_u8[i], n)

    def esc_row(i):
        return escapes[esc_at[i]: esc_at[i + 1]]

    return [{"sym_u": stream(i), "sym_v": stream(B + i),
             "esc_u": esc_row(i), "esc_v": esc_row(B + i)}
            for i in range(B)]


def merge_sections(frag: dict, lossless_np, u_ll, v_ll, bm) -> dict:
    """One unit's entropy fragment + host-side metadata -> the full
    section dict, in ``encode.field_sections`` key order (the order fixes
    the frame's byte layout)."""
    bm = np.asarray(bm)
    return {
        "sym_u": frag["sym_u"],
        "sym_v": frag["sym_v"],
        "esc_u": frag["esc_u"],
        "esc_v": frag["esc_v"],
        "lossless": np.packbits(lossless_np),
        "u_ll": np.asarray(u_ll),
        "v_ll": np.asarray(v_ll),
        "blockmap": np.packbits(bm),
        "bm_shape": np.asarray(bm.shape, dtype=np.int32),
    }


def field_sections_device(res_u, res_v, lossless_np, u_ll, v_ll,
                          bm) -> dict:
    """Device-codec twin of ``encode.field_sections`` (one field; the
    residuals stay on their device)."""
    frag = encode_streams(res_u[None], res_v[None])[0]
    return merge_sections(frag, lossless_np, u_ll, v_ll, bm)
