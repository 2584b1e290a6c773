"""Fixed-point conversion for exact critical-point predicates.

The paper (Alg. 3, lines 1-2) converts the float vector field to a scaled
int64 representation before any critical-point test, so that the SoS
determinant cascade is exact integer arithmetic.  We keep |value| < 2^bits
(default 30) so a 2x2 determinant term |u_i * v_j| < 2^60 and three-term
sums stay well inside int64.
"""
from __future__ import annotations

import numpy as np

DEFAULT_BITS = 30


def compute_scale(max_abs: float, bits: int = DEFAULT_BITS) -> float:
    """Power-of-two scale S with |round(x * S)| < 2**bits for |x| <= max_abs."""
    if max_abs <= 0.0 or not np.isfinite(max_abs):
        return 1.0
    # floor(log2(2^bits / max_abs)) guarantees max_abs * S <= 2^bits
    exp = int(np.floor(bits - np.log2(max_abs))) - 1
    return float(2.0 ** exp)


def to_fixed(u: np.ndarray, v: np.ndarray, bits: int = DEFAULT_BITS):
    """Convert float fields to int64 fixed point.  Returns (scale, U, V)."""
    max_abs = float(max(np.max(np.abs(u)), np.max(np.abs(v)), 1e-300))
    scale = compute_scale(max_abs, bits)
    ufp = np.round(np.asarray(u, dtype=np.float64) * scale).astype(np.int64)
    vfp = np.round(np.asarray(v, dtype=np.float64) * scale).astype(np.int64)
    return scale, ufp, vfp


def refix(u: np.ndarray, v: np.ndarray, scale: float):
    """Re-apply a known scale (used on decompressed data for verification)."""
    ufp = np.round(np.asarray(u, dtype=np.float64) * scale).astype(np.int64)
    vfp = np.round(np.asarray(v, dtype=np.float64) * scale).astype(np.int64)
    return ufp, vfp


def from_fixed(ufp: np.ndarray, vfp: np.ndarray, scale: float, dtype=np.float32):
    inv = 1.0 / scale
    return (ufp * inv).astype(dtype), (vfp * inv).astype(dtype)
