"""Simulation-of-Simplicity robust critical-point predicates (int64 torch).

A face carries three vector values a, b, c (int64 fixed point) with
distinct global vertex indices.  It is *crossed* by the zero set iff the
origin lies in conv{a, b, c}, decided by the signs of det(a,b), det(b,c)
and det(c,a).  A vanishing determinant is resolved by the symbolic
perturbation cascade of the JAX package's ``core/sos.py`` (exponents
4^m for u, 2*4^m for v): for index(A) < index(B) the tie-break signs are
+Bv, -Bu, -Av, +Au, then the constant -1.  The SoS sign is never zero
and depends only on (values, indices).

All inputs are int64 tensors; with |values| <= 2^30 every product stays
below 2^60 and every determinant inside int64 (fixedpoint.py).
"""
from __future__ import annotations

import torch


def _tiebreak(au, av, bu, bv):
    """SoS tie-break for det(A, B) == 0, index(A) < index(B)."""
    s = torch.sign(bv)
    s = torch.where(s != 0, s, torch.sign(-bu))
    s = torch.where(s != 0, s, torch.sign(-av))
    s = torch.where(s != 0, s, torch.sign(au))
    return torch.where(s != 0, s, torch.full_like(s, -1))


def _sign_det_sos_d(d, au, av, ma, bu, bv, mb):
    """SoS sign of det(A, B) with the determinant d precomputed."""
    s = torch.sign(d)
    tie = torch.where(ma < mb, _tiebreak(au, av, bu, bv),
                      -_tiebreak(bu, bv, au, av))
    return torch.where(s != 0, s, tie)


def sign_det_sos(au, av, ma, bu, bv, mb):
    """SoS-robust sign of det(A, B) = Au*Bv - Av*Bu."""
    return _sign_det_sos_d(au * bv - av * bu, au, av, ma, bu, bv, mb)


def face_crossed(au, av, ma, bu, bv, mb, cu, cv, mc,
                 d_ab=None, d_bc=None, d_ca=None):
    """True where the origin is in conv{a, b, c} under SoS.  The
    pairwise determinants may be passed in (ebound shares them)."""
    if d_ab is None:
        d_ab = au * bv - av * bu
        d_bc = bu * cv - bv * cu
        d_ca = cu * av - cv * au
    s1 = _sign_det_sos_d(d_ab, au, av, ma, bu, bv, mb)
    s2 = _sign_det_sos_d(d_bc, bu, bv, mb, cu, cv, mc)
    s3 = _sign_det_sos_d(d_ca, cu, cv, mc, au, av, ma)
    return (s1 == s2) & (s2 == s3)


def face_crossed_vals(uvals, vvals, idx):
    """uvals / vvals / idx of shape (..., 3) int64 -> (...,) bool."""
    return face_crossed(
        uvals[..., 0], vvals[..., 0], idx[..., 0],
        uvals[..., 1], vvals[..., 1], idx[..., 1],
        uvals[..., 2], vvals[..., 2], idx[..., 2],
    )


def barycentric_crossing(uvals, vvals):
    """Barycentric coordinates (alpha, beta, gamma) of the origin in
    conv{a, b, c} (paper Eq. 2), numpy float64 from (..., 3) int64
    values; meaningful on crossed faces only."""
    import numpy as np

    a_u, b_u, c_u = (uvals[..., i].astype(np.float64) for i in range(3))
    a_v, b_v, c_v = (vvals[..., i].astype(np.float64) for i in range(3))
    d_ab = a_u * b_v - a_v * b_u
    d_bc = b_u * c_v - b_v * c_u
    d_ca = c_u * a_v - c_v * a_u
    df = d_ab + d_bc + d_ca
    df = np.where(df == 0.0, 1.0, df)  # guarded; degenerate faces unused
    return d_bc / df, d_ca / df, d_ab / df
