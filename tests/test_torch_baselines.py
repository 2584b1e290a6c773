"""The comparison baselines and the host Huffman coder of the port
against the JAX package (CPU).

``repro_torch.core.encode``'s canonical-Huffman encoder gives the
reference's lengths, bits and sizes; each baseline of
``repro_torch.baselines`` gives the reference's compressed size and a
bitwise-equal reconstruction (sz3-like and cpsz-like with
``device="cpu"``), and cpsz-like keeps FC_t = 0.  The slice-only bound,
the all-face predicates and the face-to-vertex mask behind cpsz-like
equal the reference's.
"""
import pytest

pytest.importorskip("torch")

import numpy as np
import torch

from repro import baselines as r_baselines
from repro.core import ebound as r_ebound, encode as r_encode, \
    fixedpoint as r_fixedpoint, pipeline as r_pipeline
import repro_torch
from repro_torch import baselines
from repro_torch.core import ebound, encode, pipeline, trajectory
from repro_torch.data import synthetic


def _cumsum_field(shape=(6, 32, 32), seed=3):
    rng = np.random.default_rng(seed)
    base = np.cumsum(rng.normal(size=shape).astype(np.float32), axis=0)
    return base, base[::-1].copy()


FIELDS = {"cumsum": _cumsum_field,
          "gyre": lambda: synthetic.double_gyre(T=6, H=32, W=32)}


def _streams():
    rng = np.random.default_rng(11)
    return {
        "geometric": np.minimum(rng.geometric(0.3, 5000) - 1,
                                255).astype(np.uint8),
        "uniform": rng.integers(0, 256, 4099).astype(np.uint8),
        "one-symbol": np.full(77, 9, np.uint8),
        "two-symbols": np.array([0, 255] * 40 + [0], np.uint8),
        # a Fibonacci-skewed histogram: an unclamped tree deeper than 16
        "deep": np.repeat(np.arange(30, dtype=np.uint8),
                          [int(x) for x in np.round(
                              1.6 ** np.arange(30))]).astype(np.uint8),
    }


@pytest.mark.parametrize("name", list(_streams()))
def test_huffman_encoder_equals_reference(name):
    sym = _streams()[name]
    ln, data, n = encode.huffman_encode(sym)
    r_ln, r_data, r_n = r_encode.huffman_encode(sym)
    assert np.array_equal(ln, r_ln) and data == r_data and n == r_n
    assert encode.huffman_stream_size_bits(sym) \
        == r_encode.huffman_stream_size_bits(sym)
    assert np.array_equal(encode.huffman_decode(ln, data, n), sym)
    freq = np.bincount(sym, minlength=256)
    for limit in (8, 12, 16):
        got = encode.length_limited_lengths(freq, limit)
        assert np.array_equal(got, r_encode.length_limited_lengths(freq,
                                                                   limit))
        assert got.max() <= limit


def test_codec_helpers_equal_reference():
    assert encode.have_zstd() == r_encode.have_zstd()
    u, v = _cumsum_field((4, 16, 24))
    blob, _ = repro_torch.compress_tiled(
        u, v, repro_torch.CompressionConfig(), repro_torch.TileGrid(8, 12, 2),
        device="cpu")
    read = lambda off, ln: blob[off: off + ln]  # noqa: E731
    assert encode.tiled_header_ranged(read, len(blob)) \
        == r_encode.tiled_header_ranged(read, len(blob)) \
        == encode.tiled_header(blob)


@pytest.fixture(scope="module", params=list(FIELDS))
def field(request):
    return request.param, FIELDS[request.param]()


@pytest.mark.parametrize("name", list(r_baselines.REGISTRY))
def test_baseline_equals_reference(field, name):
    _, (u, v) = field
    want = r_baselines.REGISTRY[name](u, v, eb=1e-2)
    got = baselines.REGISTRY[name](u, v, eb=1e-2, device="cpu")
    assert sorted(got) == sorted(want)
    assert got["comp_bytes"] == want["comp_bytes"]
    assert got["ratio"] == want["ratio"] and got["name"] == want["name"]
    for k in ("u_rec", "v_rec"):
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    assert got["t_compress"] >= 0 and got["t_decompress"] >= 0


def test_cpsz_like_keeps_slice_faces(field):
    _, (u, v) = field
    out = baselines.cpsz_like(u, v, eb=1e-2, device="cpu")
    scale = r_fixedpoint.to_fixed(u, v)[0]
    fc = trajectory.false_cases(u, v, out["u_rec"], out["v_rec"], scale,
                                device="cpu")
    assert fc["FC_t"] == 0
    err = np.maximum(np.abs(out["u_rec"].astype(np.float64) - u),
                     np.abs(out["v_rec"].astype(np.float64) - v))
    assert (err <= out["eb_abs"]).all()


def test_slice_bound_predicates_and_mask_equal_reference():
    import jax.numpy as jnp
    from repro.baselines import lossy as r_lossy

    u, v = _cumsum_field((5, 12, 14))
    _, ufp, vfp = r_fixedpoint.to_fixed(u, v)
    tau = 1 << 22
    want = np.asarray(r_lossy._slice_only_eb(jnp.asarray(ufp),
                                             jnp.asarray(vfp), tau))
    got = ebound.derive_slice_eb(torch.as_tensor(ufp), torch.as_tensor(vfp),
                                 tau)
    assert np.array_equal(got.numpy(), want)
    r_sl, r_sb = r_ebound.all_face_predicates(ufp, vfp, be="numpy")
    sl, sb = ebound.all_face_predicates(torch.as_tensor(ufp),
                                        torch.as_tensor(vfp))
    assert np.array_equal(sl.numpy(), np.asarray(r_sl))
    assert np.array_equal(sb.numpy(), np.asarray(r_sb))
    rng = np.random.default_rng(2)
    bad_sl = rng.random(sl.shape) < 0.01
    bad_sb = rng.random(sb.shape) < 0.01
    assert np.array_equal(
        pipeline._faces_to_vertex_mask(bad_sl, bad_sb, 5, 12, 14),
        r_pipeline._faces_to_vertex_mask(bad_sl, bad_sb, 5, 12, 14))
    assert np.array_equal(ebound.slab_face_table(12, 14),
                          r_ebound.slab_face_table(12, 14))
    assert np.array_equal(ebound._incidence_table(12, 14, "slab"),
                          r_ebound._incidence_table(12, 14, "slab"))
