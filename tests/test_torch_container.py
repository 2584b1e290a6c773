"""The port's container code against the JAX package's.

The header writer must give the bytes of ``msgpack.packb(h,
use_bin_type=True)`` (real headers and a hypothesis strategy over the
header subset), the reader must invert it, ``pack`` must be byte-equal
for the same sections with zstd and with the zlib fallback, and damaged
containers must raise ``ContainerError``.
"""
import pytest

pytest.importorskip("torch")

import zlib

import msgpack
import numpy as np
from hypothesis import given, settings, strategies as st

import repro.core as core
from repro.core import encode as r_encode
from repro_torch.core import _msgpack, encode
from repro.data import synthetic


@pytest.fixture(scope="module")
def ref_blob():
    u, v = synthetic.double_gyre(T=4, H=12, W=16)
    blob, _ = core.compress(u, v, core.CompressionConfig(
        eb=1e-2, backend="numpy"))
    return blob


def _header_and_sections(blob):
    header, sections = r_encode.unpack(blob)
    return header, {k: np.array(v) for k, v in sections.items()}


def test_msgpack_real_header_bytes(ref_blob):
    header, sections = _header_and_sections(ref_blob)
    header = dict(header)
    header["sections"] = {n: {"off": 0, "len": a.nbytes, "dtype": str(a.dtype),
                              "shape": list(a.shape)}
                          for n, a in sections.items()}
    assert _msgpack.packb(header) == msgpack.packb(header, use_bin_type=True)
    assert _msgpack.unpackb(_msgpack.packb(header)) == header


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1,
    -2 ** 63, 0.0, -1.5, 1e300, float("inf"), True, False, None, "",
    "x" * 31, "x" * 32, "x" * 255, "x" * 256, "x" * 70000, "é中",
    b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 70000, [], list(range(15)),
    list(range(16)), list(range(70000)), {}, {str(i): i for i in range(15)},
    {str(i): i for i in range(16)}, (1, 2), {"a": {"b": [None, 1.0]}},
])
def test_msgpack_width_choices(value):
    want = msgpack.packb(value, use_bin_type=True)
    assert _msgpack.packb(value) == want
    assert _msgpack.unpackb(want) == msgpack.unpackb(want, raw=False)


_leaves = (st.none() | st.booleans()
           | st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1)
           | st.floats(allow_nan=False) | st.text(max_size=40)
           | st.binary(max_size=300))
_values = st.recursive(
    _leaves,
    lambda kids: (st.lists(kids, max_size=20)
                  | st.dictionaries(st.text(max_size=12), kids, max_size=20)),
    max_leaves=60)


@given(_values)
@settings(max_examples=200, deadline=None)
def test_msgpack_strategy_bytes_and_roundtrip(value):
    want = msgpack.packb(value, use_bin_type=True)
    assert _msgpack.packb(value) == want
    assert _msgpack.unpackb(want) == msgpack.unpackb(want, raw=False)


@pytest.mark.parametrize("bad", [b"", b"\x92\x01", b"\xc1", b"\x81\x01\x02",
                                 b"\x01\x02", b"\xd9\x05ab"])
def test_msgpack_malformed_raises(bad):
    with pytest.raises(ValueError):
        _msgpack.unpackb(bad)


@pytest.mark.parametrize("zstd", [True, False])
def test_pack_byte_equal(ref_blob, zstd, monkeypatch):
    header, sections = _header_and_sections(ref_blob)
    header.pop("codec")
    if not zstd:
        monkeypatch.setattr(r_encode, "zstandard", None)
        monkeypatch.setattr(encode, "zstandard", None)
    want = r_encode.pack(header, sections, 12)
    got = encode.pack(header, sections, 12)
    assert got == want
    assert got[:5] == (encode.MAGIC if zstd else encode.MAGIC_ZLIB)
    h2, s2 = encode.unpack(got)
    assert h2["codec"] == ("zstd" if zstd else "zlib")
    for name, arr in sections.items():
        assert np.array_equal(s2[name], arr) and s2[name].dtype == arr.dtype


def test_symbols_roundtrip_and_equal():
    rng = np.random.default_rng(0)
    res = rng.integers(-400, 400, (3, 9, 11))
    sym, esc = encode.to_symbols(res)
    rsym, resc = r_encode.to_symbols(res)
    assert np.array_equal(sym, rsym) and np.array_equal(esc, resc)
    assert np.array_equal(encode.from_symbols(sym, esc, res.shape), res)


def _damaged(blob):
    payload = r_encode.codec_decompress(blob[5:], "zstd"
                                        if blob[:5] == r_encode.MAGIC
                                        else "zlib")
    hlen = int.from_bytes(payload[:4], "little")
    yield "truncated", blob[: len(blob) // 2]
    yield "bad magic", b"XXXXX" + blob[5:]
    yield "flipped frame byte", blob[:9] + bytes([blob[9] ^ 0xFF]) + blob[10:]
    yield "header length", r_encode.MAGIC_ZLIB + zlib.compress(
        (10 ** 6).to_bytes(4, "little") + payload[4:])
    yield "header bytes", r_encode.MAGIC_ZLIB + zlib.compress(
        payload[:4] + b"\xc1" * hlen + payload[4 + hlen:])
    yield "short body", r_encode.MAGIC_ZLIB + zlib.compress(
        payload[: 4 + hlen + 10])


def test_damaged_containers_raise(ref_blob):
    import repro_torch

    for what, blob in _damaged(ref_blob):
        with pytest.raises(encode.ContainerError):
            encode.unpack(blob)
        with pytest.raises(encode.ContainerError):
            repro_torch.decompress(blob, device="cpu")


def test_refuses_unported_container_kinds(ref_blob):
    """Every SL stepper tag the JAX package writes decodes ("pallas"
    replays its stepper, here the f64 "xla" path of a 12-row field, as
    the reference's decode does), and so does the legacy pipeline, or
    no pipeline tag (the "xla" stepper, whatever the header's tag
    says); any other tag or
    pipeline, a newer version and a malformed header are refused."""
    import repro_torch

    header, sections = _header_and_sections(ref_blob)
    header.pop("codec")
    doctored = r_encode.pack(dict(header, sl_backend="pallas"), sections)
    for a, b in zip(repro_torch.decompress(doctored, device="cpu"),
                    core.decompress(doctored)):
        assert np.array_equal(a, b)
    doctored = r_encode.pack(dict(header, sl_backend="bogus"), sections)
    with pytest.raises(ValueError, match="stepper"):
        repro_torch.decompress(doctored, device="cpu")
    doctored = r_encode.pack(dict(header, version=99), sections)
    with pytest.raises(ValueError, match="version 99"):
        repro_torch.decompress(doctored, device="cpu")
    doctored = r_encode.pack(dict(header, block=0), sections)
    with pytest.raises(encode.ContainerError, match="block 0"):
        repro_torch.decompress(doctored, device="cpu")
    untagged = {k: x for k, x in header.items() if k != "pipeline"}
    for doctored in [r_encode.pack(dict(header, pipeline="legacy",
                                        sl_backend=tag), sections)
                     for tag in ("numpy", "bogus")] \
            + [r_encode.pack(untagged, sections)]:
        for a, b in zip(repro_torch.decompress(doctored, device="cpu"),
                        core.decompress(doctored)):
            assert np.array_equal(a, b)
    doctored = r_encode.pack(dict(header, pipeline="seed"), sections)
    with pytest.raises(encode.ContainerError, match="pipeline 'seed'"):
        repro_torch.decompress(doctored, device="cpu")
    # a tiled container is no monolithic frame: unpack names the reader
    with pytest.raises(encode.ContainerError, match="decompress_tiled"):
        encode.unpack(r_encode.MAGIC_TILED + b"\x00" * 32)


@pytest.mark.parametrize("section,value", [
    ("bm_shape", np.asarray([1, 1, 1], np.int32)),
    ("sym_u", np.zeros(5, np.uint8)),
    ("esc_v", np.zeros(3, np.int64)),
    ("u_ll", np.zeros(1, np.float32)),
])
def test_inconsistent_sections_raise(ref_blob, section, value):
    """Well-formed frames whose sections disagree with the header."""
    import repro_torch

    header, sections = _header_and_sections(ref_blob)
    header.pop("codec")
    sections[section] = value
    with pytest.raises(encode.ContainerError):
        repro_torch.decompress(r_encode.pack(header, sections), device="cpu")
