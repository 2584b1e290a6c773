"""Error-bound quantization + dual-quantization onto a base integer grid.

The per-vertex bound xi_v (ebound.py) is rounded down onto the ladder
xi_k = xi_unit * 2^k, and each fixed-point value is rounded half away
from zero to the nearest multiple of q_k = 2 * xi_k, expressed on the
base grid g = 2 * xi_unit:

    X_v = round(d_v / q_k) << k,      recon_v = X_v * g

Lossless vertices (xi_v < xi_unit) carry the k = 0 rounding so both
sides see a defined predictor context.  Everything is int64 except the
f64 ratio inside ``quantize_eb``, which follows the JAX package's op
order (log2 as log(x) / log(2)).
"""
from __future__ import annotations

import math

import numpy as np
import torch

DEFAULT_LEVELS = 1
_LN2 = math.log(2.0)


def ladder(tau: int, n_levels: int = DEFAULT_LEVELS):
    """Returns (xi_unit, n_usable_levels).  xi_unit >= 1."""
    tau = int(tau)
    if tau < 1:
        return 1, 0
    xi_unit = max(1, tau >> (n_levels - 1))
    kmax = int(np.floor(np.log2(tau / xi_unit))) if tau >= xi_unit else -1
    return xi_unit, kmax + 1


def quantize_eb(eb: torch.Tensor, xi_unit: int, n_levels: int):
    """int64 bounds -> (k int32 (-1 where lossless), lossless bool)."""
    xi = int(xi_unit)
    lossless = eb < xi
    ratio = (torch.clamp(eb, min=xi).to(torch.float64) / float(xi))
    k = torch.floor(torch.log(ratio) / _LN2).to(torch.int32)
    k = torch.clamp(k, 0, max(n_levels - 1, 0))
    k = torch.where(lossless, torch.full_like(k, -1), k)
    return k, lossless


def round_half_away_div(d: torch.Tensor, q) -> torch.Tensor:
    """sign(d) * ((|d| + q//2) // q) for int64 d, even int64 q."""
    mag = torch.div(torch.abs(d) + (q >> 1), q, rounding_mode="floor")
    return torch.sign(d) * mag


def dual_quantize(dfp: torch.Tensor, k: torch.Tensor, lossless: torch.Tensor,
                  xi_unit: int) -> torch.Tensor:
    """int64 fixed point -> X int64 with recon = X * 2 * xi_unit."""
    g = 2 * int(xi_unit)
    kk = torch.clamp(k, min=0).to(torch.int64)
    q = torch.full_like(kk, g) << kk
    x = round_half_away_div(dfp, q) << kk
    x0 = round_half_away_div(dfp, g)
    return torch.where(lossless, x0, x)
