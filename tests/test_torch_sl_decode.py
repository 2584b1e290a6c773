"""The port's SL decode (K3's plain version) against the JAX package.

``repro_torch.core.backend.sl_decode`` on the CPU must equal the
reference's ``repro.core.pipeline._decode_fields_parallel`` with the
numpy stepper, bit for bit, on seeded residuals and blockmaps: no SL
frame, every frame, a random third of the blocks, SL only in frame 1 or
only in the last frame, and runs of SL frames between runs without;
planes whose sides are not multiples of the block; displacements that
keep every SL pixel on the RK2 branch and ones whose substeps clamp at
n_max.  The kernel itself runs only on the card
(tests/test_torch_cuda.py holds it against this plain version).
"""
import pytest

pytest.importorskip("torch")

import numpy as np
import torch

from repro.core import backend as r_backend
from repro.core import pipeline as r_pipeline
from repro_torch.core import backend
from repro_torch.kernels.semilagrange import kernel as k3

SHAPE = (6, 37, 53)
XI_UNIT, SCALE = 1, 200.0            # g2f = 2 * xi_unit / scale = 0.01
D_MAX = 2.0
# name -> (residual amplitude, cfl_x, n_max); cfl_y = 0.7 cfl_x
AMPS = {"rk2": (20, 0.05, 8), "clamped": (400, 0.5, 4)}


def _blockmap(kind, nb, rng):
    T = nb[0]
    some = rng.random(nb[1:]) < 0.5
    some.flat[rng.integers(some.size)] = True
    bm = np.zeros(nb, dtype=bool)
    if kind == "all":
        bm[:] = True
    elif kind == "random":
        bm = rng.random(nb) < 0.3
    elif kind == "first":
        bm[1] = some
    elif kind == "last":
        bm[T - 1] = some
    elif kind == "runs":
        for t in (1, 2, 4):                    # SL, SL, none, SL, none
            bm[t] = rng.random(nb[1:]) < 0.5
        bm[1] |= some
    return bm


def _max_sl_displacement(xu, xv, bm, block, g2f, cx, cy):
    """Largest d_inf over the pixels that take an SL step."""
    T, H, W = xu.shape
    mask = np.repeat(np.repeat(bm, block, 1), block, 2)[:, :H, :W]
    mask[0] = False
    prev_u, prev_v = xu[:-1][mask[1:]], xv[:-1][mask[1:]]
    if not prev_u.size:
        return 0.0
    return float(max((np.abs(prev_u) * g2f * cx).max(),
                     (np.abs(prev_v) * g2f * cy).max()))


@pytest.mark.parametrize("amp", sorted(AMPS))
@pytest.mark.parametrize("block", [16, 8])
@pytest.mark.parametrize("kind", ["none", "all", "random", "first", "last",
                                  "runs"])
def test_sl_decode_plain_matches_reference(kind, block, amp):
    a, cx, n_max = AMPS[amp]
    cy = 0.7 * cx
    rng = np.random.default_rng([block, len(kind), a])
    T, H, W = SHAPE
    res_u = rng.integers(-a, a + 1, SHAPE).astype(np.int64)
    res_v = rng.integers(-a, a + 1, SHAPE).astype(np.int64)
    bm = _blockmap(kind, (T, -(-H // block), -(-W // block)), rng)
    want = r_pipeline._decode_fields_parallel(
        res_u, res_v, bm, SCALE, XI_UNIT, block,
        r_backend.sl_stepper("numpy", cx, cy, D_MAX, n_max))
    want = [np.asarray(w) for w in want]
    g2f = (2.0 * XI_UNIT) / SCALE
    got = backend.sl_decode(torch.as_tensor(res_u), torch.as_tensor(res_v),
                            bm, block, g2f, cx, cy, D_MAX, n_max)
    assert got[0].dtype == torch.int64 and tuple(got[0].shape) == SHAPE
    assert np.array_equal(got[0].numpy(), want[0])
    assert np.array_equal(got[1].numpy(), want[1])
    # the case reaches the regime it names
    disp = _max_sl_displacement(want[0], want[1], bm, block, g2f, cx, cy)
    if kind != "none":
        if amp == "rk2":
            assert 0 < disp <= D_MAX
        else:
            assert disp > D_MAX * n_max


def test_sl_decode_wrapper_refuses_bad_inputs():
    """The kernel wrapper checks types and shapes, then raises on CPU
    tensors: it never runs the plain version, and counts no launch."""
    T, H, W, block = 3, 20, 35, 16
    x = torch.zeros((T, H, W), dtype=torch.int64)
    bm = torch.ones((T, 2, 3), dtype=torch.uint8)
    flags = torch.ones(T, dtype=torch.uint8)
    sl = (block, 0.01, 0.1, 0.1, 2.0, 8)
    n0 = k3.sl_decode.launches
    with pytest.raises(ValueError, match="CUDA"):
        k3.sl_decode(x, x, x, x, bm, flags, *sl)
    with pytest.raises(TypeError, match="int64"):
        k3.sl_decode(x.to(torch.int32), x, x, x, bm, flags, *sl)
    with pytest.raises(TypeError, match="uint8"):
        k3.sl_decode(x, x, x, x, bm.bool(), flags, *sl)
    with pytest.raises(TypeError, match="uint8"):
        k3.sl_decode(x, x, x, x, bm, flags.to(torch.int64), *sl)
    with pytest.raises(ValueError, match="blockmap"):
        k3.sl_decode(x, x, x, x, bm[:, :, :2].contiguous(), flags, *sl)
    with pytest.raises(ValueError, match="blockmap"):
        k3.sl_decode(x, x, x, x, bm, flags[:2], *sl)
    with pytest.raises(ValueError, match="shapes"):
        k3.sl_decode(x, x, x[:2], x, bm, flags, *sl)
    assert k3.sl_decode.launches == n0 == 0
