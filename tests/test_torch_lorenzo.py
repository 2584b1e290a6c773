"""K1's contract on the CPU: one call for both components.

``lorenzo_residual(ufp, vfp, k, lossless, xi_unit, block, want_x)`` (the
plain version the CPU dispatch runs) must give, per component, the
reference's residual (``repro.core.backend.lorenzo_residual`` with the
Pallas kernel in interpret mode and with the numpy backend) and, with
``want_x``, the reference's ``quantize.dual_quantize``.  The kernel's
divide-by-constant is transcribed here from csrc/lorenzo.cu and held
against floor division on the host-side parameters the wrapper computes,
and its whole dual quantization (wrap-around included) against the plain
version on extreme int64 values.  The MoP encode makes one pair call per
verify round.  All comparisons are exact; the kernel itself runs only on
the card (tests/test_torch_cuda.py).
"""
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np
import torch

from repro.core import backend as r_backend
from repro.core import quantize as r_quantize
import repro_torch
from repro_torch.core import backend, quantize
from repro_torch.data import synthetic
from repro_torch.kernels.lorenzo import kernel as k1
from repro_torch.kernels.lorenzo import ops as lz_ops
from repro_torch.kernels.lorenzo import ref as r1

U64 = np.uint64


def _inputs(shape, xi_unit, n_levels, seed):
    """(dfp (2, *shape), k, lossless): levels 0..n_levels-1 and lossless
    vertices, and a quarter of the values exactly on a rounding half-way
    point (an odd multiple of q/2), of either sign."""
    rng = np.random.default_rng(seed)
    eb = rng.integers(0, xi_unit << n_levels, shape).astype(np.int64)
    k, ll = r_quantize.quantize_eb(jnp.asarray(eb), xi_unit, n_levels)
    k, ll = np.array(k), np.array(ll)
    dfp = rng.integers(-(2 ** 29), 2 ** 29, (2,) + shape).astype(np.int64)
    kk = np.where(ll, 0, np.maximum(k, 0)).astype(np.int64)
    half = np.int64(xi_unit) << kk                 # q / 2
    for c in range(2):
        m = rng.integers(0, np.maximum(2 ** 28 // half, 1))
        sign = rng.choice(np.array([-1, 1], np.int64), shape)
        on = rng.random(shape) < 0.25
        dfp[c] = np.where(on, sign * (2 * m + 1) * half, dfp[c])
    assert ll.any() and (k == n_levels - 1).any()
    return dfp, k, ll


@pytest.mark.parametrize("block", [16, 13])
@pytest.mark.parametrize("xi_unit", [1, 3, 1024, 2 ** 27])
def test_pair_matches_reference_residual_and_x(block, xi_unit):
    shape = (3, 40, 72)
    dfp, k, ll = _inputs(shape, xi_unit, 3, xi_unit + block)
    args = (torch.as_tensor(k), torch.as_tensor(ll), xi_unit, block)
    got = lz_ops.lorenzo_residual(torch.as_tensor(dfp[0]),
                                  torch.as_tensor(dfp[1]), *args, True)
    assert len(got) == 4 and all(g.dtype == torch.int64 for g in got)
    pair = backend.lorenzo_residual(torch.as_tensor(dfp[0]),
                                    torch.as_tensor(dfp[1]), *args)
    assert len(pair) == 2
    assert torch.equal(pair[0], got[0]) and torch.equal(pair[1], got[1])
    for c in range(2):
        d = jnp.asarray(dfp[c])
        for be in ("pallas", "numpy"):
            want = np.asarray(r_backend.lorenzo_residual(
                d, jnp.asarray(k), jnp.asarray(ll), xi_unit, block, be))
            assert np.array_equal(got[c].numpy(), want), (c, be)
        want_x = np.asarray(r_quantize.dual_quantize(
            d, jnp.asarray(k), jnp.asarray(ll), xi_unit))
        assert np.array_equal(got[2 + c].numpy(), want_x), c


def _kernel_divide(nk, g, params):
    """lorenzo.cu's ``dual_quant`` division of nk = n >> kk (uint64,
    below 2^63) by the launch constant g: the 32-bit multiply-high where
    the dividend fits 32 bits and g < 2^32, else 64-bit floor division."""
    m, sh1, sh2, fast = params
    nk = np.asarray(nk, U64)
    n32 = nk & U64(0xFFFFFFFF)
    t1 = (U64(m) * n32) >> U64(32)
    q_fast = (t1 + ((n32 - t1) >> U64(sh1))) >> U64(sh2)
    return np.where(bool(fast) & (nk < U64(2 ** 32)), q_fast, nk // U64(g))


def _dividends(g, rng):
    q32 = (2 ** 32 - 1) // g
    edges = [0, 1, g - 1, g, g + 1, 2 * g - 1, 2 * g, 2 * g + 1,
             q32 * g - 1, q32 * g, q32 * g + 1, (q32 + 1) * g - 1,
             2 ** 31 - 1, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1, 2 ** 32,
             2 ** 32 + 1, 2 ** 62, 2 ** 63 - 1]
    mults = rng.integers(1, max(2, 2 ** 32 // g), 64) * g
    return np.concatenate([
        np.array([e for e in edges if 0 <= e < 2 ** 63], U64),
        mults.astype(U64) - U64(1), mults.astype(U64),
        mults.astype(U64) + U64(1),
        rng.integers(0, 2 ** 32, 512, dtype=U64),
        rng.integers(0, 2 ** 63, 64, dtype=U64)])


@pytest.mark.parametrize("which", ["1..4096", "powers of two",
                                   "near 2^31", "random"])
def test_divisor_params_transcription_equals_floor_division(which):
    rng = np.random.default_rng(len(which))
    xis = {"1..4096": range(1, 4097),
           "powers of two": [2 ** e for e in range(62)],
           "near 2^31": range(2 ** 31 - 40, 2 ** 31 + 40),
           "random": rng.integers(1, 2 ** 31, 200).tolist()}[which]
    for xi in xis:
        g = 2 * int(xi)
        params = k1.divisor_params(g)
        assert params[3] == (g < 2 ** 32)
        assert 0 <= params[0] < 2 ** 32
        nk = _dividends(g, rng)
        got = _kernel_divide(nk, g, params)
        assert np.array_equal(got, nk // U64(g)), g


def _kernel_dual_quant(d, k, ll, xi):
    """lorenzo.cu's ``dual_quant`` on Python ints, two's complement wrap
    of the uint64 / int64 casts written out."""
    M = 2 ** 64
    g = 2 * xi
    kk = 0 if ll else max(k, 0)
    a = (-d) % M if d < 0 else d
    n = (a + (xi << kk)) % M
    nk = n >> kk
    signed = n - M if n >= 2 ** 63 else n
    fast = k1.divisor_params(g)
    if fast[3] and signed >= 0 and nk < 2 ** 32:
        mag = int(_kernel_divide([nk], g, fast)[0])
    else:
        mag = ((signed >> kk) // g) % M
    x = (mag << kk) % M
    r = x if d > 0 else ((-x) % M if d < 0 else 0)
    return r - M if r >= 2 ** 63 else r


@pytest.mark.parametrize("xi_unit", [1, 3, 2 ** 27, 2 ** 31, 2 ** 40])
def test_kernel_dual_quant_transcription_equals_plain(xi_unit):
    """Every int64 dfp: the 32-bit path, the 64-bit path (|dfp| beyond
    2^32, g >= 2^32) and the wrap of |dfp| + q/2 past 2^63."""
    rng = np.random.default_rng(xi_unit % 1000)
    edge = [0, 1, -1, 2 ** 29, -(2 ** 29), 2 ** 32 - 1, 2 ** 32, -(2 ** 32),
            2 ** 62, -(2 ** 62), 2 ** 63 - 1, -(2 ** 63) + 1, -(2 ** 63),
            2 ** 63 - 1 - xi_unit, 2 ** 63 - xi_unit, -(2 ** 63) + xi_unit]
    d = np.concatenate([np.array(edge, np.int64),
                        rng.integers(-(2 ** 63), 2 ** 63 - 1, 200,
                                     dtype=np.int64),
                        rng.integers(-(2 ** 33), 2 ** 33, 200)])
    k = rng.integers(-1, 3, d.shape).astype(np.int32)
    ll = k < 0
    want = quantize.dual_quantize(torch.as_tensor(d), torch.as_tensor(k),
                                  torch.as_tensor(ll), xi_unit).numpy()
    got = [_kernel_dual_quant(int(a), int(b), bool(c), xi_unit)
           for a, b, c in zip(d, k, ll)]
    assert np.array_equal(np.array(got, np.int64), want)


def _large_magnitude_field():
    rng = np.random.default_rng(3)
    shape = (4, 16, 16)
    u = (1.0e8 + rng.normal(0, 100.0, shape)).astype(np.float32)
    v = (1.0e8 + rng.normal(0, 100.0, shape)).astype(np.float32)
    return u, v


@pytest.mark.parametrize("predictor", ["mop", "lorenzo"])
def test_encode_makes_one_pair_call_per_round(monkeypatch, predictor):
    """The MoP encode takes X from K1's pair call (no dual_quantize of its
    own), once per verify round; the Lorenzo encode takes the pair
    without X."""
    calls, dq = [], []
    plain, plain_dq = r1.lorenzo_residual, quantize.dual_quantize

    def counted(*args):
        calls.append(args[6])
        return plain(*args)

    def counted_dq(*args):
        dq.append(len(calls))
        return plain_dq(*args)

    monkeypatch.setattr(r1, "lorenzo_residual", counted)
    monkeypatch.setattr(quantize, "dual_quantize", counted_dq)
    u, v = _large_magnitude_field()
    cfg = repro_torch.CompressionConfig(eb=6.0, mode="abs",
                                        predictor=predictor)
    blob, stats = repro_torch.compress(u, v, cfg, device="cpu")
    assert stats["verify_rounds"] >= 1
    assert calls == [predictor == "mop"] * (stats["verify_rounds"] + 1)
    # every dual_quantize ran inside a pair call (two per call)
    assert sorted(dq) == sorted(n for n in range(1, len(calls) + 1)
                                for _ in range(2))
    u2, v2 = synthetic.vortex_street(T=4, H=20, W=24)
    cfg2 = repro_torch.CompressionConfig(eb=1e-2, predictor=predictor)
    calls.clear()
    repro_torch.compress(u2, v2, cfg2, device="cpu")
    assert calls and all(c == (predictor == "mop") for c in calls)


def test_run_length_fills_the_card_and_tiles_match_source(monkeypatch):
    """The wrapper's tile is the kernel's (csrc/lorenzo.cu), and its run
    length keeps at least CTAS_PER_SM CTAs an SM where the field has
    enough frames: runs of 2 frames at the SCF analogue on 132 SMs."""
    import re
    from pathlib import Path

    src = (Path(k1.__file__).resolve().parents[2] / "csrc" /
           "lorenzo.cu").read_text()
    tile = tuple(int(re.search(rf"constexpr int {c} = (\d+);", src).group(1))
                 for c in ("kTH", "kTW"))
    assert tile == k1.TILE

    def run(T, H, W, sms=132):
        tiles = -(-H // k1.TILE[0]) * -(-W // k1.TILE[1])
        r = max(1, min(T, (T * tiles) // (k1.CTAS_PER_SM * sms)))
        assert tiles * -(-T // r) >= min(T * tiles, k1.CTAS_PER_SM * sms)
        return r

    monkeypatch.setattr(k1, "_sms", lambda device: 132)
    for shape in [(120, 100, 225), (64, 512, 512), (3, 16, 16), (1, 7, 9),
                  (500, 2048, 2048)]:
        assert k1.run_length(*shape, None) == run(*shape)
    assert k1.run_length(120, 100, 225, None) == 2
