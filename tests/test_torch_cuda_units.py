"""The unit-batched kernel entries and the tiled path on the card.

K1 ``lorenzo_residual_units``, K2 ``verify_faces_units`` and K3
``sl_decode_units`` against their plain versions, bitwise, on stacks of
tile units of the tiled pipeline's shapes (interior and edge
signatures, blocks 16 and 13, both verify modes, SL flags that differ
between units); and the tiled container written on the card == the one
written on the CPU.  These tests need a CUDA device and nvcc; elsewhere
they skip.  The file imports no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_units.py
"""
import pytest

pytest.importorskip("torch")

import numpy as np
import torch

import repro_torch
from repro_torch.core import grid, predictors, quantize
from repro_torch.data import synthetic
from repro_torch.kernels.cptest import kernel as k2, ref as r2
from repro_torch.kernels.lorenzo import kernel as k1, ref as r1
from repro_torch.kernels.semilagrange import kernel as k3, ref as r3

pytestmark = pytest.mark.cuda

# (extension, owned box (ot, oi, oj, To, Ho, Wo)) of a 128 x 128 x 32
# tile grid's units: interior of a later window, corner of the first
SIGS = {"interior": ((33, 130, 130), (1, 1, 1, 32, 128, 128)),
        "corner": ((33, 129, 129), (0, 0, 0, 32, 128, 128)),
        "ragged": ((13, 50, 37), (1, 1, 0, 11, 48, 36))}


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _lorenzo_units_inputs(B, ext, xi_unit, dev, seed):
    rng = np.random.default_rng(seed)
    shape = (B,) + ext
    eb = torch.as_tensor(rng.integers(0, 8 * xi_unit, shape), device=dev)
    k, ll = quantize.quantize_eb(eb, xi_unit, 3)
    comps = [torch.as_tensor(rng.integers(-2 ** 29, 2 ** 29, shape),
                             device=dev) for _ in range(2)]
    return (*comps, k, ll)


@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("sig", ["interior", "corner", "ragged"])
@pytest.mark.parametrize("block", [16, 13])
def test_lorenzo_units_kernel_equals_plain(dev, B, sig, block):
    ext, owned = SIGS[sig]
    args = _lorenzo_units_inputs(B, ext, 5, dev, seed=B + block)
    want = r1.lorenzo_residual_units(*args, 5, block, owned)
    n0 = k1.lorenzo_residual_units.launches
    got = k1.lorenzo_residual_units(*args, 5, block, owned)
    torch.cuda.synchronize()
    assert k1.lorenzo_residual_units.launches == n0 + 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _verify_units_inputs(B, shape, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    o = torch.randint(-3, 4, (2, B) + shape, generator=g, device=dev)
    big = torch.rand(o.shape, generator=g, device=dev) < 0.2
    o = torch.where(big, torch.randint(-(1 << 20), 1 << 20, o.shape,
                                       generator=g, device=dev), o)
    r = o + torch.randint(-2, 3, o.shape, generator=g, device=dev)
    T, H, W = shape
    tabs = grid.device_tables(H, W, str(dev))
    t = torch.arange(T, device=dev)[:, None, None] * (H * W)
    sl = (tabs["slice"][None] + t).reshape(-1, 3)
    sb = (tabs["slab"][None] + t[:-1]).reshape(-1, 3)
    s0 = torch.stack([r2.face_crossed(o[0, b].reshape(-1),
                                      o[1, b].reshape(-1), sl).reshape(T, -1)
                      for b in range(B)])
    b0 = torch.stack([r2.face_crossed(o[0, b].reshape(-1),
                                      o[1, b].reshape(-1), sb).reshape(
                                          T - 1, -1) for b in range(B)])
    forced = torch.rand((B,) + shape, generator=g, device=dev) < 0.05
    delta = torch.rand((B,) + shape, generator=g, device=dev) < 0.05
    return (r[0].contiguous(), r[1].contiguous(), o[0].contiguous(),
            o[1].contiguous(), delta, tabs["slice"], tabs["slab"], s0, b0,
            forced)


@pytest.mark.parametrize("mode", ["screen", "delta"])
@pytest.mark.parametrize("B,shape", [(1, (9, 130, 130)), (3, (9, 129, 98)),
                                     (8, (5, 34, 40))])
def test_verify_faces_units_kernel_equals_plain(dev, B, shape, mode):
    ur, vr, uo, vo, delta, st, sb, s0, b0, forced = _verify_units_inputs(
        B, shape, dev, seed=B)
    d = None if mode == "screen" else delta
    got_f, want_f = forced.clone(), forced.clone()
    n0 = k2.verify_faces_units.launches
    got = k2.verify_faces_units(ur, vr, uo, vo, d, st, sb, s0, b0, got_f)
    torch.cuda.synchronize()
    assert k2.verify_faces_units.launches == n0 + 1
    want = r2.verify_faces_units(ur, vr, uo, vo, d, st, sb, s0, b0, want_f)
    assert int(got) == int(want) > 0
    assert torch.equal(got_f, want_f)


@pytest.mark.parametrize("B,shape,block", [(1, (32, 128, 128), 16),
                                           (3, (34, 100, 98), 16),
                                           (8, (33, 130, 130), 16),
                                           (3, (12, 37, 53), 13)])
def test_sl_decode_units_kernel_equals_plain(dev, B, shape, block):
    rng = np.random.default_rng(B)
    T, H, W = shape
    nb = (B, T, -(-H // block), -(-W // block))
    res = [torch.as_tensor(rng.integers(-20, 21, (B,) + shape), device=dev)
           for _ in range(2)]
    bm = rng.random(nb) < 0.3
    bm[0] = False                      # a unit with no SL frame
    if B > 1:
        bm[1, 2:] = False              # one with SL in frame 1 only
    flags = bm.reshape(B, T, -1).any(axis=2)
    flags[:, 0] = False
    c2 = [predictors.c2_block(r, block).contiguous() for r in res]
    args = (*c2, *res, torch.as_tensor(bm.astype(np.uint8), device=dev),
            torch.as_tensor(flags.astype(np.uint8), device=dev), block, 0.01,
            0.05, 0.035, 2.0, 8)
    got = k3.sl_decode_units(*args)
    torch.cuda.synchronize()
    want = r3.sl_decode_units(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("codec", ["host", "device"])
@pytest.mark.parametrize("batch_units", [True, False])
def test_card_tiled_blob_equals_cpu_blob(dev, codec, batch_units):
    T, H, W = 8, 64, 96
    u, v = synthetic.vortex_street(T=T, H=H, W=W)
    cfg = repro_torch.CompressionConfig(
        eb=1e-3, codec=codec, batch_units=batch_units, dt=0.05,
        dx=2.0 / (W - 1), dy=1.0 / (H - 1))
    grid_ = repro_torch.TileGrid(16, 24, 3)
    b_dev, s_dev = repro_torch.compress_tiled(u, v, cfg, grid_, device=dev)
    b_cpu, _ = repro_torch.compress_tiled(u, v, cfg, grid_, device="cpu")
    assert b_dev == b_cpu
    assert (s_dev["chunks"]["verify"]["multi"] > 0) == batch_units
    d_dev = repro_torch.decompress(b_dev, device=dev)
    d_cpu = repro_torch.decompress(b_dev, device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(d_dev, d_cpu))


def test_launches_run_on_the_tensors_card():
    """Every kernel launches on its tensors' card, whatever the calling
    thread's current card: K1 (both entries), K2 ``face_crossed`` and
    ``verify_faces_units``, K3 (both entries) and K4 on ``cuda:1``
    tensors from a thread whose current card is ``cuda:0`` (a tiles-mesh
    worker thread starts on card 0) equal their plain versions."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: launches on cuda:1 from a "
                    "thread whose current card is cuda:0")
    from concurrent.futures import ThreadPoolExecutor

    dev = torch.device("cuda", 1)

    def same(got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        return all(g.device == dev and torch.equal(g, w)
                   for g, w in zip(got, want))

    def run():
        torch.cuda.set_device(0)
        out = {}
        ext, owned = SIGS["ragged"]
        args = _lorenzo_units_inputs(3, ext, 5, dev, seed=1)
        out["K1 units"] = same(k1.lorenzo_residual_units(*args, 5, 16, owned),
                               r1.lorenzo_residual_units(*args, 5, 16, owned))
        one = tuple(a[0] for a in args)
        out["K1"] = same(k1.lorenzo_residual(*one, 5, 16, want_x=True),
                         r1.lorenzo_residual(*one, 5, 16, want_x=True))
        ur, vr, uo, vo, delta, st, sb, s0, b0, forced = \
            _verify_units_inputs(3, (5, 34, 40), dev, seed=2)
        verts = (st[None] + torch.arange(5, device=dev)[:, None, None]
                 * (34 * 40)).reshape(-1, 3)
        out["K2 faces"] = same(
            k2.face_crossed(uo[0].reshape(-1), vo[0].reshape(-1), verts),
            r2.face_crossed(uo[0].reshape(-1), vo[0].reshape(-1), verts))
        got_f, want_f = forced.clone(), forced.clone()
        n_got = k2.verify_faces_units(ur, vr, uo, vo, None, st, sb, s0, b0,
                                      got_f)
        n_want = r2.verify_faces_units(ur, vr, uo, vo, None, st, sb, s0, b0,
                                       want_f)
        out["K2 units"] = int(n_got) == int(n_want) and same(got_f, want_f)
        rng = np.random.default_rng(3)
        B, T, H, W, block = 2, 6, 37, 53, 16
        res = [torch.as_tensor(rng.integers(-20, 21, (B, T, H, W)),
                               device=dev) for _ in range(2)]
        bm = rng.random((B, T, -(-H // block), -(-W // block))) < 0.3
        flags = bm.reshape(B, T, -1).any(axis=2)
        flags[:, 0] = False
        c2 = [predictors.c2_block(r, block).contiguous() for r in res]
        sl = (block, 0.01, 0.05, 0.035, 2.0, 8)
        units = (*c2, *res, torch.as_tensor(bm.astype(np.uint8), device=dev),
                 torch.as_tensor(flags.astype(np.uint8), device=dev), *sl)
        out["K3 units"] = same(k3.sl_decode_units(*units),
                               r3.sl_decode_units(*units))
        field = tuple(a[0].contiguous() for a in units[:6]) + sl
        out["K3"] = same(k3.sl_decode(*field), r3.sl_decode(*field))
        xs = [torch.as_tensor(rng.integers(-2 ** 20, 2 ** 20, (3, H, W)),
                              device=dev) for _ in range(2)]
        step = (0.01, 0.05, 0.035, 2.0, 8)
        out["K4"] = same(k3.sl_step_batched(*xs, *step),
                         r3.sl_step_batched(*xs, *step))
        torch.cuda.synchronize(dev)
        return out

    with ThreadPoolExecutor(1) as pool:
        out = pool.submit(run).result()
    assert all(out.values()), out
