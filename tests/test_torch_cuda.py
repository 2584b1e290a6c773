"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and nvcc; elsewhere they skip with the
reason.  The file imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports the JAX package.)
Kernel and plain version must agree bitwise, and a compress on the card
must write the bytes of a compress on the CPU, with either codec.
"""
import pytest

pytest.importorskip("torch")

import numpy as np
import torch

import repro_torch
from repro_torch.core import grid, predictors, quantize
from repro_torch.data import synthetic
from repro_torch.kernels.cptest import kernel as k2, ref as r2
from repro_torch.kernels.entropy import kernel as k5, ref as r5
from repro_torch.kernels.lorenzo import kernel as k1, ref as r1
from repro_torch.kernels.semilagrange import kernel as k3, ref as r3

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _lorenzo_inputs(shape, xi_unit, amp, dev, seed):
    """(ufp, vfp, k, lossless) with n_levels 3, lossless vertices and a
    quarter of the values on a rounding half-way point."""
    rng = np.random.default_rng(seed)
    eb = torch.as_tensor(rng.integers(0, 8 * xi_unit, shape), device=dev)
    k, ll = quantize.quantize_eb(eb, xi_unit, 3)
    kk = torch.where(ll, 0, k.clamp(min=0)).to(torch.int64)
    half = torch.full_like(kk, xi_unit) << kk
    out = []
    for _ in range(2):
        d = torch.as_tensor(rng.integers(-amp, amp, shape), device=dev)
        m = torch.as_tensor(rng.integers(0, 1000, shape), device=dev)
        on = torch.as_tensor(rng.random(shape) < 0.25, device=dev)
        out.append(torch.where(on, (2 * m + 1) * half, d))
    return (*out, k, ll)


def _lorenzo_check(args, xi_unit, block, run=None):
    plain = r1.lorenzo_residual(*args, xi_unit, block, True)
    for want_x in (False, True):
        n0 = k1.lorenzo_residual.launches
        got = k1.lorenzo_residual(*args, xi_unit, block, want_x, run)
        torch.cuda.synchronize()
        assert k1.lorenzo_residual.launches == n0 + 1
        assert len(got) == (4 if want_x else 2)
        for g, w in zip(got, plain):
            assert torch.equal(g, w)


@pytest.mark.parametrize("xi_unit,block", [(1, 16), (3, 16), (1024, 13)])
def test_lorenzo_kernel_equals_plain(dev, xi_unit, block):
    args = _lorenzo_inputs((4, 70, 90), xi_unit, 2 ** 29, dev, xi_unit)
    _lorenzo_check(args, xi_unit, block)


# |dfp| beyond 2^32 and up to the int64 edge (the 64-bit path and the
# wrap of |d| + q/2), g >= 2^32 (no 32-bit path), frame runs that do not
# divide T, blocks that are and are not tile edges, partial tiles
@pytest.mark.parametrize("shape,xi_unit,block,amp,run", [
    ((7, 70, 90), 3, 16, 2 ** 40, None),
    ((7, 70, 90), 2 ** 27, 13, 2 ** 62, 3),
    ((9, 33, 130), 2 ** 31, 16, 2 ** 33, 4),
    ((5, 100, 225), 1, 40, 2 ** 29, 2),
    ((6, 17, 200), 7, 5, 2 ** 29, 1),
])
def test_lorenzo_kernel_wide_path_and_runs(dev, shape, xi_unit, block, amp,
                                           run):
    ufp, vfp, k, ll = _lorenzo_inputs(shape, xi_unit, amp, dev, amp % 97)
    ufp[0, 0, :4] = torch.tensor([2 ** 63 - 1, -(2 ** 63) + 1, 2 ** 62,
                                  -(2 ** 63)], device=dev)
    _lorenzo_check((ufp, vfp, k, ll), xi_unit, block, run)


def test_face_crossed_kernel_equals_plain(dev):
    rng = np.random.default_rng(0)
    n_v, n = 3000, 100_000
    u = rng.integers(-3, 4, n_v)
    v = rng.integers(-(2 ** 29), 2 ** 29, n_v)
    v[rng.random(n_v) < 0.3] = 0
    verts = torch.as_tensor(rng.integers(0, n_v, (n, 3)), device=dev)
    uu = torch.as_tensor(u, device=dev)
    vv = torch.as_tensor(v, device=dev)
    got = k2.face_crossed(uu, vv, verts)
    torch.cuda.synchronize()
    assert torch.equal(got, r2.face_crossed(uu, vv, verts))


def _vf_fields(shape, seed, dev):
    """(ufp, vfp, ur_fp, vr_fp) on the card: small values with sign ties,
    some large ones, collinear neighbour pairs, reconstructions moved by
    0, 1 or 2 (tests/test_torch_verify_faces.py's fixture); a (12, 100,
    225) shape takes the fixed-point vortex street instead."""
    rng = np.random.default_rng(seed)
    if shape == (12, 100, 225):
        u, v = synthetic.vortex_street(T=12, H=100, W=225)
        o = np.stack([np.round(u * 2.0 ** 8), np.round(v * 2.0 ** 8)])
        o = o.astype(np.int64)
    else:
        o = rng.integers(-3, 4, (2,) + shape).astype(np.int64)
        big = rng.random((2,) + shape) < 0.2
        o[big] = rng.integers(-(2 ** 20), 2 ** 20, int(big.sum()))
        flat = o.reshape(2, -1)
        src = rng.choice(flat.shape[1], max(1, flat.shape[1] // 8),
                         replace=False)
        dst = np.minimum(src + 1, flat.shape[1] - 1)
        flat[:, dst] = flat[:, src] * rng.integers(-2, 3, len(src))
    r = o + rng.integers(-2, 3, o.shape)
    same = rng.random(o.shape) < 0.4
    r[same] = o[same]
    return tuple(torch.as_tensor(a, device=dev) for a in (o[0], o[1], r[0],
                                                          r[1]))


def _vf_preds(ufp, vfp):
    """(slice_tab, slab_tab, slice0, slab0): the original predicates of
    every face by the plain predicate (any T, also 1)."""
    T, H, W = ufp.shape
    tabs = grid.device_tables(H, W, str(ufp.device))
    t = torch.arange(T, device=ufp.device)[:, None, None] * (H * W)
    uf, vf = ufp.reshape(-1), vfp.reshape(-1)
    sl = tabs["slice"][None] + t
    sb = tabs["slab"][None] + t[:-1]
    Fs, Fb = sl.shape[1], sb.shape[1]
    slice0 = r2.face_crossed(uf, vf, sl.reshape(-1, 3)).reshape(T, Fs)
    slab0 = r2.face_crossed(uf, vf, sb.reshape(-1, 3)).reshape(T - 1, Fb)
    return tabs["slice"], tabs["slab"], slice0, slab0


def _vf_delta(kind, shape, dev):
    d = torch.zeros(shape, dtype=torch.bool, device=dev)
    if kind == "full":
        d[:] = True
    elif kind == "random":
        g = torch.Generator(device=dev).manual_seed(3)
        d = torch.rand(shape, generator=g, device=dev) < 0.05
    elif kind == "border":
        d[:, 0, :] = d[:, -1, :] = d[:, :, 0] = d[:, :, -1] = True
    return None if kind == "screen" else d


def _vf_check(ufp, vfp, ur, vr, delta, forced0):
    """Kernel == plain (count and forced mask), one launch; the count."""
    preds = _vf_preds(ufp, vfp)
    got_f, want_f = forced0.clone(), forced0.clone()
    n0 = k2.verify_faces.launches
    got = k2.verify_faces(ur, vr, ufp, vfp, delta, *preds, got_f)
    torch.cuda.synchronize()
    assert k2.verify_faces.launches == n0 + 1
    want = r2.verify_faces(ur, vr, ufp, vfp, delta, *preds, want_f)
    assert got.dtype == torch.int64 and got.ndim == 0
    assert int(got) == int(want)
    assert torch.equal(got_f, want_f)
    assert torch.equal(got_f | forced0, got_f)     # pre-set bits stay set
    return int(got)


@pytest.mark.parametrize("mode", ["screen", "empty", "full", "random",
                                  "border"])
@pytest.mark.parametrize("shape", [(4, 16, 16), (5, 9, 13), (3, 7, 5),
                                   (1, 8, 8), (12, 100, 225)])
def test_verify_faces_kernel_equals_plain(dev, shape, mode):
    ufp, vfp, ur, vr = _vf_fields(shape, sum(shape), dev)
    forced0 = torch.rand(shape, device=dev) < 0.1
    n = _vf_check(ufp, vfp, ur, vr, _vf_delta(mode, shape, dev), forced0)
    if mode in ("screen", "full"):
        assert n > 0
    if mode == "empty":
        assert n == 0


@pytest.mark.parametrize("mode", ["screen", "random", "border"])
@pytest.mark.parametrize("shape", [(3, 2, 1025), (2, 3, 6000),
                                   (10, 4, 20000)])
def test_verify_faces_kernel_wide_planes(dev, shape, mode):
    """Planes wider than one CTA's column block (kMaxCols): the launch
    splits W into blocks whose faces reach one column into the next."""
    ufp, vfp, ur, vr = _vf_fields(shape, sum(shape), dev)
    forced0 = torch.rand(shape, device=dev) < 0.1
    n = _vf_check(ufp, vfp, ur, vr, _vf_delta(mode, shape, dev), forced0)
    assert n > 0


def test_verify_faces_kernel_every_and_no_face_selected(dev):
    """All-zero originals: the screen clears no face; one strict sign in
    both fields: it clears every face (count 0, forced untouched).  Back
    to back on one stream, so the workspace must come back zeroed."""
    for shape in [(4, 16, 16), (1, 8, 8), (12, 100, 225)]:
        zero = torch.zeros(shape, dtype=torch.int64, device=dev)
        _, _, ur, vr = _vf_fields(shape, 1, dev)
        forced0 = torch.zeros(shape, dtype=torch.bool, device=dev)
        assert _vf_check(zero, zero, ur, vr, None, forced0) > 0
        pos = torch.full(shape, 7, dtype=torch.int64, device=dev)
        forced0 = torch.rand(shape, device=dev) < 0.3
        assert _vf_check(pos, pos, pos + 1, pos + 2, None, forced0) == 0


def test_card_verify_rounds_launch_verify_faces(dev):
    """The verify-firing fixture on the card: the reference's accounting
    [506, 0], one verify_faces launch a round, no face_crossed."""
    rng = np.random.default_rng(3)
    u = (1.0e8 + rng.normal(0, 100.0, (4, 16, 16))).astype(np.float32)
    v = (1.0e8 + rng.normal(0, 100.0, (4, 16, 16))).astype(np.float32)
    cfg = repro_torch.CompressionConfig(eb=6.0, mode="abs")
    k2.verify_faces.launches = k2.face_crossed.launches = 0
    blob, stats = repro_torch.compress(u, v, cfg, device=dev)
    assert stats["verify_bad_counts"] == [506, 0]
    assert k2.verify_faces.launches == 2 and k2.face_crossed.launches == 0
    assert blob == repro_torch.compress(u, v, cfg, device="cpu")[0]


@pytest.mark.parametrize("amp,cfl", [(50, 0.05), (50_000, 0.01),
                                     (50_000, 0.2)])
def test_sl_kernel_equals_plain(dev, amp, cfl):
    rng = np.random.default_rng(amp)
    xu = torch.as_tensor(rng.integers(-amp, amp + 1, (61, 83)), device=dev)
    xv = torch.as_tensor(rng.integers(-amp, amp + 1, (61, 83)), device=dev)
    got = k3.sl_step(xu, xv, 0.01, cfl, cfl, 2.0, 32)
    torch.cuda.synchronize()
    want = r3.sl_step(xu, xv, 0.01, cfl, cfl, 2.0, 32)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# 3000: departures of up to 3 cells beside RK2 pixels, at the halo's
# edge; 50_000: 100-cell substeps far beyond it; 61x83 leaves partial
# 32x32 tiles at the borders
@pytest.mark.parametrize("amp,cfl", [(50, 0.05), (3000, 0.1), (50_000, 0.2)])
def test_sl_batched_kernel_equals_per_frame_kernel_and_plain(dev, amp, cfl):
    rng = np.random.default_rng(amp)
    xu = torch.as_tensor(rng.integers(-amp, amp + 1, (5, 61, 83)), device=dev)
    xv = torch.as_tensor(rng.integers(-amp, amp + 1, (5, 61, 83)), device=dev)
    xu[2] //= 100
    args = (0.01, cfl, cfl, 2.0, 32)
    n0 = k3.sl_step_batched.launches
    got = k3.sl_step_batched(xu, xv, *args)
    torch.cuda.synchronize()
    assert k3.sl_step_batched.launches == n0 + 1
    want = r3.sl_step_batched(xu, xv, *args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for b in range(xu.shape[0]):
        one = k3.sl_step(xu[b], xv[b], *args)
        assert torch.equal(got[0][b], one[0])
        assert torch.equal(got[1][b], one[1])


def _decode_inputs(kind, shape, block, amp, dev):
    """(c2u, c2v, res_u, res_v, blockmap, flags) for sl_decode: seeded
    residuals of amplitude ``amp`` and a blockmap of the named kind."""
    rng = np.random.default_rng([block, amp, *shape])
    T, H, W = shape
    nb = (T, -(-H // block), -(-W // block))
    res = [torch.as_tensor(rng.integers(-amp, amp + 1, shape), device=dev)
           for _ in range(2)]
    some = rng.random(nb[1:]) < 0.5
    some.flat[0] = True
    bm = np.zeros(nb, dtype=bool)
    if kind == "all":
        bm[:] = True
    elif kind == "random":
        bm = rng.random(nb) < 0.3
    elif kind == "first":
        bm[1] = some
    elif kind == "last":
        bm[-1] = some
    elif kind == "runs":
        bm[1:T // 3] = some
        bm[T // 2:T // 2 + 2] = some
    flags = bm.reshape(T, -1).any(axis=1)
    flags[0] = False
    c2 = [predictors.c2_block(r, block).contiguous() for r in res]
    return (*c2, *res,
            torch.as_tensor(bm.astype(np.uint8), device=dev),
            torch.as_tensor(flags.astype(np.uint8), device=dev))


# (residual amplitude, cfl, n_max): RK2 only / substeps clamped at n_max
_DECODE_AMPS = {"rk2": (20, 0.05, 8), "clamped": (400, 0.5, 4)}


@pytest.mark.parametrize("shape,block,kind,amp", [
    *[((6, 37, 53), b, k, a) for b in (16, 8)
      for k in ("none", "all", "random", "first", "last", "runs")
      for a in ("rk2", "clamped")],
    ((120, 100, 225), 16, "random", "rk2"),
    ((120, 100, 225), 16, "all", "clamped"),
    ((16, 512, 512), 16, "runs", "rk2"),
    ((16, 512, 512), 40, "random", "clamped"),
])
def test_sl_decode_kernel_equals_plain(dev, shape, block, kind, amp):
    a, cfl, n_max = _DECODE_AMPS[amp]
    args = _decode_inputs(kind, shape, block, a, dev) + (
        block, 0.01, cfl, 0.7 * cfl, 2.0, n_max)
    n0 = k3.sl_decode.launches
    got = k3.sl_decode(*args)
    torch.cuda.synchronize()
    assert k3.sl_decode.launches == n0 + 1 and k3.sl_decode.grid >= 1
    want = r3.sl_decode(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("B,n,offset", [(1, 1, 0), (3, 1000, 0),
                                        (8, 4097, 5), (2, 1 << 20, 3),
                                        (8, (1 << 24) + 5, 0)])
def test_histogram_kernel_equals_plain(dev, B, n, offset):
    """Random, all-zero, all-255 and only-symbols->=4 rows, ragged n and a
    start that is not 16-byte aligned."""
    rng = np.random.default_rng(n)
    flat = rng.integers(0, 256, offset + B * n).astype(np.uint8)
    flat[offset::2] = rng.integers(0, 4, len(flat[offset::2]))
    sym = torch.as_tensor(flat, device=dev)[offset:].view(B, n)
    if B >= 3:
        sym[1] = 0
        sym[2] = 255
    if B >= 4:
        sym[3] = torch.randint(4, 256, (n,), dtype=torch.uint8, device=dev)
    n0 = k5.symbol_histogram.launches
    got = k5.symbol_histogram(sym)
    torch.cuda.synchronize()
    assert k5.symbol_histogram.launches == n0 + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, r5.symbol_histogram(sym))


def test_histogram_kernel_leaves_workspace_clean(dev):
    """Back-to-back launches of different B and n on one stream (the
    workspace is reused and must come back zeroed) each equal the plain
    version."""
    rng = np.random.default_rng(7)
    for B, n in [(2, 3_000_001), (5, 999), (2, 3_000_001), (1, 17),
                 (9, 70_001)]:
        sym = torch.as_tensor(rng.integers(0, 6, (B, n)).astype(np.uint8),
                              device=dev)
        got = k5.symbol_histogram(sym)
        torch.cuda.synchronize()
        assert torch.equal(got, r5.symbol_histogram(sym)), (B, n)


@pytest.mark.parametrize("codec", ["host", "device"])
def test_card_blob_equals_cpu_blob(dev, codec):
    u, v = synthetic.vortex_street(T=6, H=48, W=64)
    cfg = repro_torch.CompressionConfig(eb=1e-2, dt=0.05, dx=2.0 / 63,
                                        dy=1.0 / 47, codec=codec)
    b_dev, s_dev = repro_torch.compress(u, v, cfg, device=dev)
    b_cpu, _ = repro_torch.compress(u, v, cfg, device="cpu")
    assert b_dev == b_cpu and s_dev["sl_block_frac"] > 0
    for a, b in zip(repro_torch.decompress(b_dev, device=dev),
                    repro_torch.decompress(b_dev, device="cpu")):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("codec", ["host", "device"])
def test_card_adaptive_blob_equals_cpu_blob(dev, codec):
    from repro_torch.core import ebpolicy, encode

    u, v = synthetic.vortex_street(T=6, H=48, W=64)
    pol = ebpolicy.TilePolicy.make(
        2, 12, 16, default=4e-2, values={(0, 1, 1): 1e-2, (1, 2, 3): 5e-3})
    cfg = repro_torch.CompressionConfig(
        eb=1e-2, dt=0.05, dx=2.0 / 63, dy=1.0 / 47, codec=codec,
        eb_policy=pol, n_levels=ebpolicy.levels_for(pol))
    b_dev, _ = repro_torch.compress(u, v, cfg, device=dev)
    b_cpu, _ = repro_torch.compress(u, v, cfg, device="cpu")
    assert b_dev == b_cpu
    assert encode.unpack(b_dev)[0]["version"] == 3
    for a, b in zip(repro_torch.decompress(b_dev, device=dev),
                    repro_torch.decompress(b_dev, device="cpu")):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("codec", ["host", "device"])
@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_card_nonfinite_blob_equals_cpu_blob(dev, bad, codec):
    u, v = synthetic.vortex_street(T=4, H=20, W=24)
    u = u.copy()
    u.flat[37] = bad
    cfg = repro_torch.CompressionConfig(eb=1e-2, mode="abs", codec=codec)
    with np.errstate(invalid="ignore"):
        b_dev, _ = repro_torch.compress(u, v, cfg, device=dev)
        b_cpu, _ = repro_torch.compress(u, v, cfg, device="cpu")
    assert b_dev == b_cpu
    ur, _ = repro_torch.decompress(b_dev, device=dev)
    assert np.array_equal(ur.view(np.uint32), u.view(np.uint32))
