"""The port's exact integer foundations against the JAX package.

Fixed point, grid tables, the SoS predicate, quantization, the
block-local Lorenzo transforms and the per-vertex eb derivation must be
bit-equal to ``repro.core`` on the same numpy inputs.  Every comparison
is exact: the stages are int64, and the only floats (the eb division
and floor, the quantize ratio) follow the reference's op order.
"""
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np
import torch

from repro.core import ebound as r_ebound
from repro.core import fixedpoint as r_fixedpoint
from repro.core import grid as r_grid
from repro.core import predictors as r_predictors
from repro.core import quantize as r_quantize
from repro.core import sos as r_sos
from repro.data import synthetic as r_synthetic
from repro_torch.core import ebound, fixedpoint, grid, predictors, quantize, sos
from repro_torch.data import synthetic


def T(a):
    return torch.as_tensor(np.asarray(a))


def test_synthetic_fields_equal():
    for name in ("vortex_street", "double_gyre", "heated_plume"):
        a = getattr(r_synthetic, name)(T=3, H=12, W=16)
        b = getattr(synthetic, name)(T=3, H=12, W=16)
        assert all(np.array_equal(x, y) for x, y in zip(a, b)), name


@pytest.mark.parametrize("bits", [20, 30])
def test_fixedpoint_equal(bits):
    rng = np.random.default_rng(bits)
    u = rng.normal(0, 3, (3, 7, 9)).astype(np.float32)
    v = rng.normal(0, 0.1, (3, 7, 9)).astype(np.float32)
    s1, u1, v1 = r_fixedpoint.to_fixed(u, v, bits)
    s2, u2, v2 = fixedpoint.to_fixed(u, v, bits)
    assert s1 == s2 and np.array_equal(u1, u2) and np.array_equal(v1, v2)


@pytest.mark.parametrize("H,W", [(5, 7), (12, 16)])
def test_grid_tables_equal(H, W):
    rf, pf = r_grid.slab_faces(H, W), grid.slab_faces(H, W)
    for name in rf:
        assert np.array_equal(rf[name], pf[name]), name
    assert np.array_equal(r_ebound.slab_face_table(H, W),
                          grid.slab_face_table(H, W))
    for kind in ("slice", "slab"):
        assert np.array_equal(r_ebound._incidence_table(H, W, kind),
                              grid.incidence_table(H, W, kind))
    tabs = grid.device_tables(H, W, "cpu")
    assert tabs["slab"].dtype == torch.int64
    assert np.array_equal(tabs["slice"].numpy(), rf["slice0"])


@pytest.mark.parametrize("case", ["random", "ties", "zeros"])
def test_sos_face_crossed_equal(case):
    rng = np.random.default_rng(7)
    n = 4000
    if case == "random":
        u = rng.integers(-(2 ** 29), 2 ** 29, (n, 3))
        v = rng.integers(-(2 ** 29), 2 ** 29, (n, 3))
    elif case == "ties":
        # small values make vanishing determinants common
        u = rng.integers(-2, 3, (n, 3))
        v = rng.integers(-2, 3, (n, 3))
    else:
        u = rng.integers(-(2 ** 29), 2 ** 29, (n, 3))
        v = rng.integers(-(2 ** 29), 2 ** 29, (n, 3))
        u[rng.random((n, 3)) < 0.4] = 0
        v[rng.random((n, 3)) < 0.4] = 0
    idx = np.stack([rng.permutation(3 * n)[:n] for _ in range(3)], 1)
    want = r_sos.face_crossed_vals(np, u, v, idx)
    got = sos.face_crossed_vals(T(u), T(v), T(idx)).numpy()
    assert np.array_equal(want, got)
    d = sos.sign_det_sos(T(u[:, 0]), T(v[:, 0]), T(idx[:, 0]),
                         T(u[:, 1]), T(v[:, 1]), T(idx[:, 1])).numpy()
    assert np.array_equal(d, r_sos.sign_det_sos(
        np, u[:, 0], v[:, 0], idx[:, 0], u[:, 1], v[:, 1], idx[:, 1]))


@pytest.mark.parametrize("tau,n_levels", [(100, 1), (2 ** 20, 1), (2 ** 20, 4),
                                          (0, 1)])
def test_quantize_equal(tau, n_levels):
    rng = np.random.default_rng(tau + n_levels)
    assert quantize.ladder(tau, n_levels) == r_quantize.ladder(tau, n_levels)
    xi_unit, _ = r_quantize.ladder(tau, n_levels)
    shape = (3, 20, 24)
    eb = rng.integers(0, tau + 2, shape)
    dfp = rng.integers(-(2 ** 29), 2 ** 29, shape)
    k1, ll1 = r_quantize.quantize_eb(jnp.asarray(eb), xi_unit, n_levels)
    k2, ll2 = quantize.quantize_eb(T(eb), xi_unit, n_levels)
    assert np.array_equal(np.asarray(k1), k2.numpy())
    assert np.array_equal(np.asarray(ll1), ll2.numpy())
    x1 = r_quantize.dual_quantize(jnp.asarray(dfp), k1, ll1, xi_unit)
    x2 = quantize.dual_quantize(T(dfp), k2, ll2, xi_unit)
    assert np.array_equal(np.asarray(x1), x2.numpy())


@pytest.mark.parametrize("shape,block", [((3, 40, 36), 16), ((2, 17, 23), 5)])
def test_lorenzo_transforms_equal(shape, block):
    rng = np.random.default_rng(1)
    x = rng.integers(-(2 ** 40), 2 ** 40, shape)
    d1 = np.asarray(r_predictors.d2_block(jnp.asarray(x), block))
    assert np.array_equal(d1, predictors.d2_block(T(x), block).numpy())
    c1 = np.asarray(r_predictors.c2_block(jnp.asarray(x), block))
    assert np.array_equal(c1, predictors.c2_block(T(x), block).numpy())
    e1 = np.asarray(r_predictors.lorenzo_encode(jnp.asarray(x), block))
    e2 = predictors.lorenzo_encode(T(x), block)
    assert np.array_equal(e1, e2.numpy())
    # exact inverse: X_t = X_{t-1} + C2(res_t)
    dec = torch.cumsum(predictors.c2_block(e2, block), dim=0)
    assert np.array_equal(dec.numpy(), x)


@pytest.mark.parametrize("field", ["vortex", "random", "zeros"])
def test_derive_vertex_eb_equal(field):
    if field == "vortex":
        u, v = r_synthetic.vortex_street(T=4, H=14, W=18)
    else:
        rng = np.random.default_rng(5)
        u = rng.normal(0, 1, (3, 11, 13)).astype(np.float32)
        v = rng.normal(0, 1, (3, 11, 13)).astype(np.float32)
        if field == "zeros":       # exact zeros: degenerate faces, SoS ties
            u[:, ::2, ::3] = 0
            v[:, 1::2, ::2] = 0
    scale, ufp, vfp = r_fixedpoint.to_fixed(u, v)
    tau = int(1e-3 * scale)
    eb1, sl1, sb1 = r_ebound.derive_vertex_eb_jit(
        jnp.asarray(ufp), jnp.asarray(vfp), tau)
    eb2, sl2, sb2 = ebound.derive_vertex_eb(T(ufp), T(vfp), tau)
    assert np.array_equal(np.asarray(eb1), eb2.numpy())
    assert np.array_equal(np.asarray(sl1), sl2.numpy())
    assert np.array_equal(np.asarray(sb1), sb2.numpy())
