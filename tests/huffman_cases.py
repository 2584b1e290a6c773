"""Huffman sections for the tests of K6 (the card decode of a CPTH1
symbol section) and its plain version: valid, incomplete, damaged and
truncated streams, each with the host decode's answer.

``CASES`` maps a name to a function of no argument that returns
(lengths uint8[256], data bytes, n).  The file imports no JAX, so the
card tests import it too.
"""
import struct

import numpy as np
import torch

from repro_torch.core import encode, entropy
from repro_torch.kernels.entropy import ref


def pack(sym, lengths) -> bytes:
    """uint8 symbols coded with the canonical code of ``lengths``, as the
    device codec's bitpack writes them."""
    lengths = np.asarray(lengths, np.int32)
    codes, _ = encode.canonical_codes(lengths)
    buf, nbits = entropy.bitpack(torch.as_tensor(np.asarray(sym, np.uint8))[None],
                                 lengths[None], codes[None])
    return buf[0, : (int(nbits[0]) + 7) // 8].numpy().tobytes()


def device_section(rows):
    """The device codec's section of one int64 residual row."""
    rows = np.asarray(rows, np.int64)[None]
    sec = entropy.encode_streams(rows[:, None], rows[:, None])[0]["sym_u"]
    return sec.lengths, sec.data, sec.n


def _normal(n, scale, seed):
    rng = np.random.default_rng(seed)
    return np.round(rng.standard_normal(n) * scale).astype(np.int64)


def _table(pairs):
    ln = np.zeros(256, np.uint8)
    for s, l in pairs:
        ln[s] = l
    return ln


# a complete code with one code of every length 1..15 and two of 16
LEN16 = _table([(s, s + 1) for s in range(15)] + [(15, 16), (16, 16)])
# an incomplete code (Kraft 3/4): windows that start with 11 map nothing
SPARSE = _table([(0, 1), (1, 3), (2, 3)])
FLAT8 = np.full(256, 8, np.uint8)     # never resynchronises off 8 bits


def _random(lengths, n, seed):
    rng = np.random.default_rng(seed)
    syms = np.nonzero(lengths)[0]
    sym = rng.choice(syms, n)
    return lengths, pack(sym, lengths), n


def _damaged(n, seed):
    ln, data, _ = _random(SPARSE, n, seed)
    mid = len(data) // 2
    return ln, data[:mid] + b"\xff\xff" + data[mid + 2:], n


def _truncated(n, seed):
    ln, data, _ = device_section(_normal(n, 3, seed))
    return ln, data[: len(data) // 2], n


def _exact(n):
    # eight 1-bit codes fill the byte: the chain ends on the last bit
    return _table([(7, 1), (9, 1)]), bytes([0b00000000]), n


CASES = {
    "skewed": lambda: device_section(_normal(3000, 3, 1)),
    "skewed-scalar": lambda: device_section(_normal(700, 3, 2)),
    "esc-heavy": lambda: device_section(_normal(2500, 300, 3)),
    "single-symbol": lambda: device_section(np.zeros(2100, np.int64)),
    "len16": lambda: _random(LEN16, 3000, 4),
    "flat8": lambda: _random(FLAT8, 2200, 5),
    "incomplete": lambda: _random(SPARSE, 3000, 6),
    "damaged": lambda: _damaged(3000, 7),
    "damaged-scalar": lambda: _damaged(900, 8),
    "truncated": lambda: _truncated(3000, 9),
    "truncated-scalar": lambda: _truncated(1000, 10),
    "exact-end-plus-one": lambda: _exact(9),
    "exact-end-plus-two": lambda: _exact(10),
    "empty-stream-n1": lambda: (SPARSE, b"", 1),
    "empty-stream-n2": lambda: (SPARSE, b"", 2),
    "empty-stream-padding": lambda: (SPARSE, b"", 2500),
    "n1": lambda: device_section(np.array([5])),
    # 8-bit codes: n bytes, neither a multiple of 4 nor of 16
    "bytes-5": lambda: _random(FLAT8, 5, 11),
    "bytes-17": lambda: _random(FLAT8, 17, 12),
    "bytes-2051": lambda: _random(FLAT8, 2051, 13),
    "short-len16": lambda: _random(LEN16, 9, 14),
}


def host_decode(lengths, data, n):
    """The host decode's answer: (symbols, None) or (None, the exception
    type ``encode.unpack`` would raise)."""
    meta = {"enc": "huff", "dtype": "uint8", "shape": [n],
            "lengths": np.asarray(lengths, np.uint8).tobytes()}
    try:
        return encode._decode_section("sym_u", meta, data), None
    except encode.ContainerError as e:
        return None, type(e)


def huff_sections(blob: bytes):
    """(name, lengths, bitstream bytes, n) of each Huffman section of a
    CPTH1 container, undecoded."""
    payload = blob[len(encode.MAGIC_HUF):]
    (hlen,) = struct.unpack("<I", payload[:4])
    header = encode._msgpack.unpackb(payload[4: 4 + hlen])
    base = 4 + hlen
    return [(name, np.frombuffer(meta["lengths"], np.uint8),
             payload[base + meta["off"]: base + meta["off"] + meta["len"]],
             int(np.prod(meta["shape"], dtype=np.int64)))
            for name, meta in header["sections"].items()
            if meta.get("enc") == "huff"]


def padded(data: bytes) -> torch.Tensor:
    """The section's bytes zero-padded as K6 reads them (a multiple of 4
    bytes, and 8 past the end)."""
    out = torch.zeros((len(data) + 3) // 4 * 4 + 8, dtype=torch.uint8)
    out[: len(data)] = torch.tensor(np.frombuffer(data, np.uint8))
    return out


def tables(lengths):
    """K6's decode tables and fill symbol of a length table."""
    ln = np.asarray(lengths, np.int32)
    return ref.decode_tables(ln, encode.canonical_codes(ln)[0])
