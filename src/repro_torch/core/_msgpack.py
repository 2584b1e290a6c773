"""The msgpack subset of the container header, writer and reader.

The container header is ``msgpack.packb(header, use_bin_type=True)``.
This module writes the same bytes for the types a header holds -- maps,
arrays (list/tuple), str, bytes, int, float (float64), bool and None --
choosing the smallest encoding exactly as msgpack-python does, and
reads them back (``unpackb`` with ``raw=False`` semantics: str as str,
bin as bytes, arrays as lists).  Anything else raises ``TypeError``
when packing and ``ValueError`` when unpacking.
"""
from __future__ import annotations

import struct


def _pack_int(n: int, out: bytearray) -> None:
    if n < 0:
        if n >= -32:
            out += struct.pack(">b", n)
        elif n >= -(1 << 7):
            out += b"\xd0" + struct.pack(">b", n)
        elif n >= -(1 << 15):
            out += b"\xd1" + struct.pack(">h", n)
        elif n >= -(1 << 31):
            out += b"\xd2" + struct.pack(">i", n)
        elif n >= -(1 << 63):
            out += b"\xd3" + struct.pack(">q", n)
        else:
            raise OverflowError(f"int {n} out of msgpack range")
    elif n < 128:
        out.append(n)
    elif n < (1 << 8):
        out += b"\xcc" + struct.pack(">B", n)
    elif n < (1 << 16):
        out += b"\xcd" + struct.pack(">H", n)
    elif n < (1 << 32):
        out += b"\xce" + struct.pack(">I", n)
    elif n < (1 << 64):
        out += b"\xcf" + struct.pack(">Q", n)
    else:
        raise OverflowError(f"int {n} out of msgpack range")


def _pack_len(n: int, fix: int, fixmax: int, w8, w16: int, w32: int,
              out: bytearray) -> None:
    if n < fixmax:
        out.append(fix | n)
    elif w8 is not None and n < (1 << 8):
        out += bytes([w8]) + struct.pack(">B", n)
    elif n < (1 << 16):
        out += bytes([w16]) + struct.pack(">H", n)
    elif n < (1 << 32):
        out += bytes([w32]) + struct.pack(">I", n)
    else:
        raise ValueError(f"msgpack object too large ({n})")


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xA0, 32, 0xD9, 0xDA, 0xDB, out)
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        if len(raw) < (1 << 8):
            out += b"\xc4" + struct.pack(">B", len(raw))
        elif len(raw) < (1 << 16):
            out += b"\xc5" + struct.pack(">H", len(raw))
        else:
            out += b"\xc6" + struct.pack(">I", len(raw))
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, None, 0xDC, 0xDD, out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, None, 0xDE, 0xDF, out)
        for key, val in obj.items():
            _pack(key, out)
            _pack(val, out)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def packb(obj) -> bytes:
    """Bytes equal to ``msgpack.packb(obj, use_bin_type=True)``."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("truncated msgpack data")
        raw = bytes(self.data[self.pos:end])
        self.pos = end
        return raw

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self, depth: int = 0):
        if depth > 100:
            raise ValueError("msgpack nesting too deep")
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, depth)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F, depth)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self.unpack(fixed[b])
        if b in (0xC4, 0xC5, 0xC6):
            return self.take(self.unpack({0xC4: ">B", 0xC5: ">H",
                                          0xC6: ">I"}[b]))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str(self.unpack({0xD9: ">B", 0xDA: ">H",
                                         0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"),
                              depth)
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"), depth)
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def str(self, n: int) -> str:
        return self.take(n).decode("utf-8")

    def array(self, n: int, depth: int) -> list:
        return [self.obj(depth + 1) for _ in range(n)]

    def map(self, n: int, depth: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj(depth + 1)
            if not isinstance(key, (str, bytes)):
                raise ValueError(f"map key of type {type(key).__name__}")
            out[key] = self.obj(depth + 1)
        return out


def unpackb(data: bytes):
    """Inverse of ``packb``; raises ValueError on malformed, truncated
    or trailing bytes."""
    r = _Reader(data)
    obj = r.obj()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after "
                         f"msgpack object")
    return obj
