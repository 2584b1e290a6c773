"""Block-wise adaptive Mixture of Predictors (paper Sec. VI).

For each (frame, spatial tile) both candidate residual fields are scored
by estimated rate

    R_p = H0(hist_p) + lambda * escape_frac_p + 1 / (2 * block^2)

and SL is picked only when its relative improvement over 3DL exceeds
the gate.  Frame 0 is always 3DL.

The per-tile histograms are exact integer counts on the tensors'
device.  The rate model is float64 and runs on the host CPU for every
device, so the blockmap -- which decides the container bytes -- cannot
depend on the device's log/sum rounding.  It follows the JAX package's
op order: log2 as log(x) / log(2), one reduction over the 256 bins.
"""
from __future__ import annotations

import math

import torch

from .. import obs

CLIP = 255           # folded residual clip; >= CLIP is an escape symbol
LAMBDA = 16.0        # bits charged per escaped (raw-stored) sample
GATE = 3e-4          # relative-improvement gate for selecting SL
_LN2 = math.log(2.0)


def fold(res: torch.Tensor) -> torch.Tensor:
    """Zigzag fold signed residuals to non-negative ints."""
    return torch.where(res >= 0, 2 * res, -2 * res - 1)


def _tile_ids(T, H, W, block, device):
    nbi = -(-H // block)
    nbj = -(-W // block)
    ti = torch.arange(H, device=device) // block
    tj = torch.arange(W, device=device) // block
    tid2 = ti[:, None] * nbj + tj[None, :]
    tid = (torch.arange(T, device=device)[:, None, None] * (nbi * nbj)
           + tid2[None])
    return tid, nbi, nbj


def _rate(hist: torch.Tensor, block: int) -> torch.Tensor:
    """Estimated bits/sample from (n_tiles, 256) histograms (CPU f64)."""
    n = torch.clamp(hist.sum(dim=-1).to(torch.float64), min=1.0)
    p = hist.to(torch.float64) / n[..., None]
    logp = torch.log(torch.clamp(p, min=1e-300)) / _LN2
    ent = -torch.where(p > 0, p * logp, torch.zeros_like(p)).sum(dim=-1)
    esc = hist[..., CLIP].to(torch.float64) / n
    return ent + LAMBDA * esc + 1.0 / (block * block * 2)


def select(res3_u, res3_v, ressl_u, ressl_v, block: int) -> torch.Tensor:
    """Per-(frame, tile) predictor choice: (T, nbi, nbj) bool on the host
    CPU, True selects SL."""
    with obs.span("mop.select") as sp:
        T, H, W = res3_u.shape
        tid, nbi, nbj = _tile_ids(T, H, W, block, res3_u.device)
        sp.set(tiles=T * nbi * nbj)
        n_bins = T * nbi * nbj * (CLIP + 1)
        base = (tid * (CLIP + 1)).reshape(-1)

        def hist_pair(ru, rv):
            h = torch.zeros(n_bins, dtype=torch.int32, device=ru.device)
            for r in (ru, rv):
                # the reference's scatter-add semantics: a negative key
                # (the fold of a non-finite value's residual wraps) is
                # wrapped once by n_bins, and a key still out of range is
                # dropped (counted in one spare bin past the end, which
                # keeps it sync-free)
                key = base + torch.clamp(fold(r), max=CLIP).reshape(-1)
                key = torch.where(key < 0, key + n_bins, key)
                key = torch.where((key >= 0) & (key < n_bins), key, n_bins)
                h += torch.bincount(key, minlength=n_bins + 1)[:n_bins].to(
                    torch.int32)
            return h.reshape(-1, CLIP + 1).cpu()

        r3 = _rate(hist_pair(res3_u, res3_v), block)
        rsl = _rate(hist_pair(ressl_u, ressl_v), block)
        improve = (r3 - rsl) / torch.clamp(r3, min=1e-12)
        use_sl = (improve > GATE).reshape(T, nbi, nbj)
        use_sl[0] = False  # no previous frame at t = 0
        return use_sl


def assemble(res3: torch.Tensor, ressl: torch.Tensor, blockmap: torch.Tensor,
             block: int) -> torch.Tensor:
    """Merge residual fields according to the (host) blockmap."""
    T, H, W = res3.shape
    mask = blockmap.to(res3.device)
    mask = mask.repeat_interleave(block, dim=1).repeat_interleave(block, dim=2)
    return torch.where(mask[:, :H, :W], ressl, res3)


def select_units(res3_u, res3_v, ressl_u, ressl_v, block: int):
    """``select`` of B (B, T, H, W) tile units at once: the units' frames
    go through one histogram pass (tiles never mix frames, so each
    tile's rate is the one its unit alone gives) and frame 0 of every
    unit is 3DL.  Returns (B, T, nbi, nbj) bool on the host CPU."""
    B, T, H, W = res3_u.shape

    def flat(r):
        return r.reshape(B * T, H, W)

    use_sl = select(flat(res3_u), flat(res3_v), flat(ressl_u),
                    flat(ressl_v), block)
    use_sl = use_sl.reshape(B, T, *use_sl.shape[1:])
    use_sl[:, 0] = False
    return use_sl
