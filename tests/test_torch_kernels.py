"""Plain versions of the port's kernels K1-K4 against the JAX package.

K1 (Lorenzo residual) and K2 (SoS face predicate) must equal the
reference's Pallas kernels, run in interpret mode as
tests/test_backend_parity.py runs them, and its numpy backend.  K3 (the
SL stepper) must equal the reference's numpy stepper bit for bit,
including displacements above d_max * n_max where the substeps clamp;
K4 (the stepper over a stack of frames) must equal K3 frame by frame.
K5 is held against the reference in tests/test_torch_entropy.py.  All
comparisons are exact.  The kernels themselves run only on the
card: tests/test_torch_cuda.py holds them against these plain versions.
"""
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np
import torch

from repro.core import backend as r_backend
from repro.core import quantize as r_quantize
from repro_torch.core import backend
from repro_torch.kernels.cptest import ops as cp_ops
from repro_torch.kernels.lorenzo import ops as lz_ops
from repro_torch.kernels.semilagrange import ops as sl_ops


@pytest.mark.parametrize("shape,tau", [((3, 64, 64), 100),
                                       ((2, 40, 72), 2 ** 20)])
def test_lorenzo_plain_matches_pallas_and_numpy(shape, tau):
    rng = np.random.default_rng(0)
    dfp = rng.integers(-(2 ** 29), 2 ** 29, (2,) + shape).astype(np.int64)
    xi_unit, n_levels = r_quantize.ladder(tau)
    eb = rng.integers(0, tau + 1, shape).astype(np.int64)
    k, lossless = r_quantize.quantize_eb(jnp.asarray(eb), xi_unit, n_levels)
    got = lz_ops.lorenzo_residual(
        torch.as_tensor(dfp[0]), torch.as_tensor(dfp[1]),
        torch.as_tensor(np.array(k)), torch.as_tensor(np.array(lossless)),
        xi_unit, 16)
    for c in range(2):
        want = {be: np.asarray(r_backend.lorenzo_residual(
            jnp.asarray(dfp[c]), k, lossless, xi_unit, 16, be))
            for be in ("pallas", "numpy")}
        assert got[c].dtype == torch.int64
        assert np.array_equal(got[c].numpy(), want["pallas"])
        assert np.array_equal(got[c].numpy(), want["numpy"])


@pytest.mark.parametrize("xi_unit", [1, 3])
def test_lorenzo_plain_small_xi_unit(xi_unit):
    """xi_unit < 4 demoted the int32 TPU kernel; the port's int64 plain
    version (and kernel) needs no demotion."""
    rng = np.random.default_rng(xi_unit)
    shape = (3, 33, 47)
    dfp = rng.integers(-(2 ** 29), 2 ** 29, (2,) + shape).astype(np.int64)
    eb = rng.integers(0, 8 * xi_unit, shape).astype(np.int64)
    k, ll = r_quantize.quantize_eb(jnp.asarray(eb), xi_unit, 3)
    got = backend.lorenzo_residual(torch.as_tensor(dfp[0]),
                                   torch.as_tensor(dfp[1]),
                                   torch.as_tensor(np.array(k)),
                                   torch.as_tensor(np.array(ll)),
                                   xi_unit, 16)
    for c in range(2):
        want = r_backend._lorenzo_residual_np(dfp[c], np.asarray(k),
                                              np.asarray(ll), xi_unit, 16)
        assert np.array_equal(got[c].numpy(), want)


@pytest.mark.parametrize("n", [5, 300])
def test_face_crossed_plain_matches_pallas_and_numpy(n):
    # the inputs of tests/test_backend_parity.py::test_face_crossed_op_parity
    rng = np.random.default_rng(n)
    u = rng.integers(-(2 ** 29), 2 ** 29, (n, 3)).astype(np.int64)
    v = rng.integers(-(2 ** 29), 2 ** 29, (n, 3)).astype(np.int64)
    u[:: max(n // 5, 1)] = 0
    idx = np.arange(3 * n, dtype=np.int64).reshape(n, 3)
    want = {be: np.asarray(r_backend.face_crossed(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(idx), backend=be,
        n_verts=3 * n)) for be in ("pallas", "numpy")}
    # the port's op gathers from flat value arrays by vertex id
    u_flat = np.empty(3 * n, np.int64)
    v_flat = np.empty(3 * n, np.int64)
    u_flat[idx] = u
    v_flat[idx] = v
    got = cp_ops.face_crossed(torch.as_tensor(u_flat),
                              torch.as_tensor(v_flat), torch.as_tensor(idx))
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want["pallas"])
    assert np.array_equal(got.numpy(), want["numpy"])


def test_face_crossed_plain_shared_vertices():
    """Faces that share vertices (the verify rounds' case): the SoS ids
    are the gather indices."""
    rng = np.random.default_rng(9)
    n_v, n = 50, 2000
    u_flat = rng.integers(-3, 4, n_v).astype(np.int64)
    v_flat = rng.integers(-3, 4, n_v).astype(np.int64)
    verts = np.sort(np.stack([rng.choice(n_v, 3, replace=False)
                              for _ in range(n)]), axis=1)
    want = r_backend.face_crossed(u_flat[verts], v_flat[verts], verts,
                                  backend="numpy")
    got = cp_ops.face_crossed(torch.as_tensor(u_flat),
                              torch.as_tensor(v_flat), torch.as_tensor(verts))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("amp,cfl,n_max", [
    (500, 0.5, 8),          # RK2 and a few substeps
    (50_000, 0.01, 32),     # ~5-cell displacements
    (50_000, 0.2, 32),      # ~100 cells: above d_max * n_max = 64, clamped
    (70_000, 0.5, 4),       # ~350 cells, n_max = 4
])
def test_sl_plain_matches_numpy_stepper(amp, cfl, n_max):
    rng = np.random.default_rng(amp + n_max)
    H, W = 37, 53
    xu = rng.integers(-amp, amp + 1, (H, W)).astype(np.int64)
    xv = rng.integers(-amp, amp + 1, (H, W)).astype(np.int64)
    g2f = 0.01
    want = r_backend._sl_predict_frame_np(xu, xv, g2f, cfl, 0.7 * cfl, 2.0,
                                          n_max)
    got = sl_ops.sl_step(torch.as_tensor(xu), torch.as_tensor(xv), g2f,
                         cfl, 0.7 * cfl, 2.0, n_max)
    assert got[0].dtype == torch.int64
    assert np.array_equal(got[0].numpy(), want[0])
    assert np.array_equal(got[1].numpy(), want[1])


@pytest.mark.parametrize("amp,cfl,n_max", [(500, 0.5, 8), (50_000, 0.2, 32)])
def test_sl_batched_plain_matches_per_frame(amp, cfl, n_max):
    """K4's plain version over a stack whose frames need different
    substep counts (one frame at rest) equals K3's plain version and the
    reference's numpy stepper frame by frame, and the encoder's
    predictions go through it."""
    rng = np.random.default_rng(amp)
    B, H, W = 4, 29, 41
    xu = rng.integers(-amp, amp + 1, (B, H, W)).astype(np.int64)
    xv = rng.integers(-amp, amp + 1, (B, H, W)).astype(np.int64)
    xu[1] //= 100
    xv[1] //= 100
    xu[2] = 0
    g2f = 0.01
    args = (g2f, cfl, 0.7 * cfl, 2.0, n_max)
    pu, pv = sl_ops.sl_step_batched(torch.as_tensor(xu), torch.as_tensor(xv),
                                    *args)
    assert pu.shape == (B, H, W) and pu.dtype == torch.int64
    for b in range(B):
        want = r_backend._sl_predict_frame_np(xu[b], xv[b], *args)
        one = sl_ops.sl_step(torch.as_tensor(xu[b]), torch.as_tensor(xv[b]),
                             *args)
        assert np.array_equal(pu[b].numpy(), want[0])
        assert np.array_equal(pv[b].numpy(), want[1])
        assert torch.equal(pu[b], one[0]) and torch.equal(pv[b], one[1])
    full_u = torch.as_tensor(np.concatenate([xu, xu[:1]]))
    full_v = torch.as_tensor(np.concatenate([xv, xv[:1]]))
    enc = backend.sl_predictions(full_u, full_v, *args)
    assert torch.equal(enc[0], pu) and torch.equal(enc[1], pv)


def test_symbol_histogram_dispatch_plain():
    rng = np.random.default_rng(1)
    sym = rng.integers(0, 256, (3, 777)).astype(np.uint8)
    got = backend.symbol_histogram(torch.as_tensor(sym))
    assert np.array_equal(got.numpy(), r_backend._symbol_histogram_np(sym))


def test_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never runs its plain version: given a CPU tensor
    it raises (the ops dispatch chooses the plain version instead)."""
    from repro_torch.kernels.cptest import kernel as k2
    from repro_torch.kernels.entropy import kernel as k5
    from repro_torch.kernels.lorenzo import kernel as k1
    from repro_torch.kernels.semilagrange import kernel as k3

    x = torch.zeros((2, 4, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        k1.lorenzo_residual(x, x, x.to(torch.int32), x.bool(), 1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        k2.face_crossed(x.reshape(-1), x.reshape(-1),
                        torch.zeros((1, 3), dtype=torch.int64))
    tab = torch.zeros((1, 3), dtype=torch.int64)
    forced = x.bool()
    with pytest.raises(ValueError, match="CUDA"):
        k2.verify_faces(x, x, x, x, None, tab, tab,
                        torch.zeros((2, 1), dtype=torch.bool),
                        torch.zeros((1, 1), dtype=torch.bool), forced)
    with pytest.raises(ValueError, match="CUDA"):
        k3.sl_step(x[0], x[0], 0.1, 1.0, 1.0, 2.0, 8)
    with pytest.raises(ValueError, match="CUDA"):
        k3.sl_step_batched(x, x, 0.1, 1.0, 1.0, 2.0, 8)
    with pytest.raises(ValueError, match="CUDA"):
        k5.symbol_histogram(x[0].to(torch.uint8))
    assert k1.lorenzo_residual.launches == 0
    assert k2.verify_faces.launches == 0 and not forced.any()
    assert k3.sl_step_batched.launches == 0
    assert k5.symbol_histogram.launches == 0
