"""The port's device entropy codec (``codec="device"``, CPTH1) against the
JAX package's (CPU).

The plain symbol histogram (K5's plain version) must equal the
reference's numpy mirror and its Pallas kernel in interpret mode; the
port's symbolize, table build and bitpack must equal the reference's
numpy mirrors; ``encode_streams`` fragments must equal the reference's
and be independent of the batch; and ``repro_torch.compress(...,
codec="device", device="cpu")`` must write the bytes of
``repro.core.compress(..., backend="numpy", codec="device")``, with
cross-decode bitwise in both directions.  Every comparison is exact.
K5 itself runs only on the card: tests/test_torch_cuda.py holds it
against the plain version.
"""
import pytest

pytest.importorskip("torch")

import numpy as np
import torch

import repro.core as core
from repro.core import backend as r_backend
from repro.core import encode as r_encode
from repro.core import entropy as r_entropy
import repro_torch
from repro_torch.core import encode, entropy
from repro_torch.data import synthetic
from repro_torch.kernels.entropy import ops as ent_ops


def _sym_rows(B, n, seed):
    rng = np.random.default_rng(seed)
    sym = rng.integers(0, 256, (B, n)).astype(np.uint8)
    # small residuals: most symbols are 0..3
    sym[:, ::3] = rng.integers(0, 4, sym[:, ::3].shape)
    if B >= 3:
        sym[1] = 0
        sym[2] = 255
    return sym


@pytest.mark.parametrize("B,n", [(1, 512), (3, 512), (5, 1000), (4, 1000)])
def test_histogram_plain_matches_numpy_and_pallas(B, n):
    from repro.kernels.entropy import ops as r_ops

    sym = _sym_rows(B, n, B * n)
    want = r_backend._symbol_histogram_np(sym)
    pallas = np.asarray(r_ops.symbol_histogram(sym, force_pallas=True))
    got = ent_ops.symbol_histogram(torch.as_tensor(sym))
    assert got.dtype == torch.int32 and got.shape == (B, 256)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), pallas)
    assert (got.sum(dim=1) == n).all()


def _residual_rows(seed=0, B=4, n=2 * 12 * 16, spikes=True):
    rng = np.random.default_rng(seed)
    rows = np.round(rng.standard_normal((B, n)) * 7).astype(np.int64)
    if spikes:
        rows[:, ::61] = 10 ** 7           # escapes
    rows[1] = 3                           # one symbol only (zigzag 6)
    return rows


def _kraft_fallback_row(n_rare=2):
    """A row whose clamped Shannon lengths break Kraft: symbol i < 19
    holds 2^(19-i) of 2^20 symbols (lengths i+1, clamped to 16 from i =
    15 on), plus two symbols that occur once (length 16)."""
    counts = [2 ** (19 - i) for i in range(19)] + [1] * n_rare
    return np.repeat(np.arange(len(counts)), counts).astype(np.int64)


def test_kraft_fallback_row_falls_back():
    sym = np.minimum(2 * _kraft_fallback_row(), 255)
    hist = r_backend._symbol_histogram_np(sym[None].astype(np.uint8))
    ln, _ = entropy.build_tables_batch(hist)
    assert set(np.unique(ln[0])) == {0, 8}


@pytest.mark.parametrize("case", ["spikes", "plain", "kraft_fallback"])
def test_symbolize_and_bitpack_match_numpy_mirrors(case):
    if case == "kraft_fallback":
        rows = _kraft_fallback_row()[None]
    else:
        rows = _residual_rows(spikes=case == "spikes")
    sym_w, hist_w, escbuf_w, n_esc_w = r_entropy._symbolize_np(rows)
    sym, hist, escapes, n_esc = entropy.symbolize(torch.as_tensor(rows))
    assert np.array_equal(sym.numpy(), sym_w)
    assert np.array_equal(hist.numpy(), hist_w)
    assert np.array_equal(n_esc.numpy(), n_esc_w)
    at = np.concatenate([[0], np.cumsum(n_esc_w)])
    for i, k in enumerate(n_esc_w):
        assert np.array_equal(escapes.numpy()[at[i]: at[i + 1]],
                              escbuf_w[i, :k])
    if case == "spikes":
        assert n_esc_w.sum() > 0
    lengths, codes = entropy.build_tables_batch(hist.numpy())
    want_l, want_c = r_entropy.build_tables_batch(hist_w)
    assert np.array_equal(lengths, want_l) and np.array_equal(codes, want_c)
    buf_w, nbits_w = r_entropy._bitpack_np(sym_w, want_l, want_c)
    buf, nbits = entropy.bitpack(sym, lengths, codes)
    assert buf.dtype == torch.uint8
    assert np.array_equal(buf.numpy(), buf_w)
    assert np.array_equal(nbits.numpy(), nbits_w)


def _zipf_hists():
    # the fuzzed histograms of tests/test_entropy_device.py
    rng = np.random.default_rng(7)
    hists = []
    for _ in range(40):
        hist = np.zeros(256, np.int64)
        k = int(rng.integers(1, 200))
        idx = rng.choice(256, k, replace=False)
        hist[idx] = rng.zipf(1.6, k).clip(1, 10 ** 6)
        hists.append(hist)
    hists.append(np.eye(256, dtype=np.int64)[17] * 999)   # single symbol
    return np.stack(hists)


def test_build_tables_batch_matches_reference():
    hist = _zipf_hists()
    lengths, codes = entropy.build_tables_batch(hist)
    want_l, want_c = r_entropy.build_tables_batch(hist)
    assert lengths.dtype == want_l.dtype and codes.dtype == want_c.dtype
    assert np.array_equal(lengths, want_l) and np.array_equal(codes, want_c)
    for r in range(hist.shape[0]):
        ref_codes, _ = encode.canonical_codes(lengths[r].astype(np.uint8))
        present = hist[r] > 0
        assert np.array_equal(codes[r][present],
                              ref_codes[present].astype(np.uint32))


def _stacks(n_units=5, shape=(2, 12, 16), seed=0):
    # the stacks of tests/test_entropy_device.py, with escapes
    rng = np.random.default_rng(seed)
    ru = np.round(rng.standard_normal((n_units,) + shape) * 7)
    rv = np.round(rng.standard_normal((n_units,) + shape) * 7)
    ru.reshape(n_units, -1)[:, ::61] = 10 ** 7
    return ru.astype(np.int64), rv.astype(np.int64)


def _same_fragment(a, b):
    for key in ("sym_u", "sym_v"):
        assert a[key].data == b[key].data
        assert np.array_equal(a[key].lengths, b[key].lengths)
        assert a[key].lengths.dtype == b[key].lengths.dtype == np.uint8
        assert a[key].n == b[key].n
    for key in ("esc_u", "esc_v"):
        assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype
        assert np.array_equal(np.asarray(a[key]), np.asarray(b[key]))


@pytest.mark.parametrize("n_units", [1, 5])
def test_encode_streams_match_reference(n_units):
    ru, rv = _stacks(n_units)
    want = r_entropy.encode_streams(ru, rv, "numpy")
    got = entropy.encode_streams(torch.as_tensor(ru), torch.as_tensor(rv))
    assert len(got) == len(want) == n_units
    for a, b in zip(got, want):
        _same_fragment(a, b)


def test_batched_equals_sequential_fragments():
    ru, rv = _stacks(5)
    batched = entropy.encode_streams(ru, rv)
    for i, frag in enumerate(batched):
        _same_fragment(frag, entropy.encode_streams(ru[i:i + 1],
                                                    rv[i:i + 1])[0])


def test_decode_symbols_inverts_bitpack():
    ru, rv = _stacks(3)
    for i, frag in enumerate(entropy.encode_streams(ru, rv)):
        for key, ekey, res in (("sym_u", "esc_u", ru[i]),
                               ("sym_v", "esc_v", rv[i])):
            sym, esc = encode.to_symbols(res)
            sec = frag[key]
            assert np.array_equal(
                entropy.decode_symbols(sec.lengths, sec.data, sec.n), sym)
            assert np.array_equal(frag[ekey], esc)


@pytest.mark.parametrize("n", [100, 3000, 70_000])
def test_huffman_decode_matches_reference(n):
    """Both decoder paths (scalar below 2048 symbols, vectorized above)
    against the reference's, on a skewed stream."""
    rng = np.random.default_rng(n)
    rows = np.round(rng.standard_normal((1, n)) * 3).astype(np.int64)
    frag = entropy.encode_streams(rows[:, None], rows[:, None])[0]
    sec = frag["sym_u"]
    ln = sec.lengths.astype(np.int32)
    got = encode.huffman_decode(ln, sec.data, n)
    assert np.array_equal(got, r_encode.huffman_decode(ln, sec.data, n))
    assert np.array_equal(got, encode.to_symbols(rows[0])[0])


# ----------------------------------------------------------------------
# containers
# ----------------------------------------------------------------------

_VORTEX = (6, 32, 48)


def _cases():
    T, H, W = _VORTEX
    u, v = synthetic.vortex_street(T=T, H=H, W=W)
    meta = dict(dt=0.05, dx=2.0 / (W - 1), dy=1.0 / (H - 1))
    cases = {f"vortex-{p}": (u, v, dict(eb=1e-3, predictor=p, **meta))
             for p in ("lorenzo", "sl", "mop")}
    # a MoP case whose blockmap mixes both predictors
    u, v = synthetic.vortex_street(T=6, H=48, W=64)
    cases["vortex48-mop"] = (u, v, dict(eb=1e-2, dt=0.05, dx=2.0 / 63,
                                        dy=1.0 / 47))
    # the verify-firing fixture of tests/test_backend_parity.py
    rng = np.random.default_rng(3)
    u = (1.0e8 + rng.normal(0, 100.0, (4, 16, 16))).astype(np.float32)
    v = (1.0e8 + rng.normal(0, 100.0, (4, 16, 16))).astype(np.float32)
    cases["verify-fixture"] = (u, v, dict(eb=6.0, mode="abs",
                                          predictor="mop"))
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def runs():
    """name -> (u, v, ref CPTH1 blob, port CPTH1 blob, port stats, port
    host-codec blob)."""
    out = {}
    for name, (u, v, kw) in CASES.items():
        rb, _ = core.compress(u, v, core.CompressionConfig(
            backend="numpy", codec="device", **kw))
        pb, ps = repro_torch.compress(
            u, v, repro_torch.CompressionConfig(codec="device", **kw),
            device="cpu")
        hb, _ = repro_torch.compress(u, v, repro_torch.CompressionConfig(**kw),
                                     device="cpu")
        out[name] = (u, v, rb, pb, ps, hb)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_device_codec_container_byte_equal(runs, name):
    u, v, rb, pb, ps, hb = runs[name]
    assert pb == rb
    assert pb[:5] == encode.MAGIC_HUF and hb[:5] != encode.MAGIC_HUF
    header, sections = encode.unpack(pb)
    assert header["codec"] == "huffman" and header["sl_backend"] == "numpy"
    # the symbol streams decode to the host codec's symbols
    _, host_sections = encode.unpack(hb)
    for key in ("sym_u", "sym_v", "esc_u", "esc_v", "lossless", "blockmap"):
        assert np.array_equal(sections[key], host_sections[key])
    if name == "verify-fixture":
        assert ps["verify_rounds"] >= 1


@pytest.mark.parametrize("name", list(CASES))
def test_device_codec_cross_decode_bitwise(runs, name):
    u, v, rb, pb, ps, hb = runs[name]
    ref_of_port = core.decompress(pb)
    port_of_ref = repro_torch.decompress(rb, device="cpu")
    port_of_port = repro_torch.decompress(pb, device="cpu")
    port_of_host = repro_torch.decompress(hb, device="cpu")
    for a, b, c, d in zip(ref_of_port, port_of_ref, port_of_port,
                          port_of_host):
        assert a.dtype == np.float32 and np.array_equal(a, b)
        assert np.array_equal(a, c) and np.array_equal(a, d)


def test_pack_huf_byte_equal(runs):
    """The CPTH1 writer, the ``lengths`` msgpack bin values included:
    re-encoding the streams of a reference container and packing them
    gives its bytes back, in both packages."""
    _, _, rb, _, _, _ = runs["vortex48-mop"]
    header, sections = r_encode.unpack(rb)
    header.pop("codec")
    n = sections["sym_u"].size
    res = [r_encode.from_symbols(sections[f"sym_{c}"], sections[f"esc_{c}"],
                                 (1, n)) for c in "uv"]
    frag = r_entropy.encode_streams(res[0], res[1], "numpy")[0]
    r_secs = dict(sections, sym_u=frag["sym_u"], sym_v=frag["sym_v"])
    p_secs = dict(sections, **{
        k: encode.HuffSection(frag[k].data, frag[k].lengths, n)
        for k in ("sym_u", "sym_v")})
    assert encode.pack(header, p_secs) == r_encode.pack(header, r_secs) == rb


def _huf_blob(runs, **meta_edits):
    """The vortex MoP CPTH1 container rebuilt with edited sym_u entries."""
    _, _, rb, _, _, _ = runs["vortex-mop"]
    payload = rb[5:]
    hlen = int.from_bytes(payload[:4], "little")
    import msgpack

    header = msgpack.unpackb(payload[4: 4 + hlen], raw=False)
    header["sections"]["sym_u"].update(meta_edits)
    hdr = msgpack.packb(header, use_bin_type=True)
    return (encode.MAGIC_HUF + len(hdr).to_bytes(4, "little") + hdr
            + payload[4 + hlen:])


@pytest.mark.parametrize("what", [
    "truncated", "short", "mangled header", "kraft", "max length",
    "table size", "unknown enc", "corrupt zlib",
])
def test_damaged_cpth1_raises(runs, what):
    _, _, rb, _, _, _ = runs["vortex-mop"]
    if what == "truncated":
        blob = rb[: len(rb) // 2]
    elif what == "short":
        blob = rb[:7]
    elif what == "mangled header":
        blob = bytearray(rb)
        blob[12] ^= 0xFF                      # inside the msgpack header
        blob = bytes(blob)
    elif what == "kraft":
        bad = np.zeros(256, np.uint8)
        bad[:4] = 1                           # four 1-bit codes: Kraft 2
        blob = _huf_blob(runs, lengths=bad.tobytes())
    elif what == "max length":
        blob = _huf_blob(runs, lengths=np.full(256, 31, np.uint8).tobytes())
    elif what == "table size":
        blob = _huf_blob(runs, lengths=b"\x08" * 255)
    elif what == "unknown enc":
        blob = _huf_blob(runs, enc="lz4")
    else:
        blob = _huf_blob(runs, enc="zlib")    # raw bitstream, not zlib
    with pytest.raises(encode.ContainerError):
        encode.unpack(blob)
    with pytest.raises(encode.ContainerError):
        repro_torch.decompress(blob, device="cpu")
