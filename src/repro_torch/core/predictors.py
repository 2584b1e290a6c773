"""Predictors on the dual-quantized integer field X (quantize.py).

Block-local 3D Lorenzo: res_0 = D2(X_0), res_t = D2(X_t) - D2(X_{t-1}),
with D2 the tile-local (``block`` x ``block``) 2D first-order difference;
decode is X_t = X_{t-1} + C2(res_t) with C2 the tile-local inclusive 2D
cumsum.  Exact int64 inverses.

Semi-Lagrangian (SL): backtrace every pixel along the previous frame's
velocity -- RK2 midpoint when the CFL displacement d_inf <= d_max,
otherwise ceil(d_inf / d_max) (at most n_max) clamped Euler substeps --
and bilinear-sample frame t-1 at the departure point.
``sl_predict_frame`` is the plain float64 version: a literal
transcription of the JAX package's numpy stepper
(``backend._sl_predict_frame_np``), op for op, so on the CPU it is
bitwise equal to that stepper, one frame or a stack of frames.  Each
torch op rounds once (no fused multiply-add), which is also what the
CUDA kernels do (built with ``-fmad=false``).
"""
from __future__ import annotations

import torch

DEFAULT_BLOCK = 16


# ----------------------------------------------------------------------
# block-local Lorenzo
# ----------------------------------------------------------------------

def _shift1(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x[..., i-1, ...] along ``dim`` with zero at i == 0."""
    out = torch.zeros_like(x)
    n = x.shape[dim]
    out.narrow(dim, 1, n - 1).copy_(x.narrow(dim, 0, n - 1))
    return out


def _edge_mask(n: int, block: int, like: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(n, device=like.device)
    return ((idx % block) != 0).to(like.dtype)


def d2_block(x: torch.Tensor, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Tile-local 2D first-order difference over the last two dims."""
    mi = _edge_mask(x.shape[-2], block, x)[:, None]
    mj = _edge_mask(x.shape[-1], block, x)[None, :]
    xi = _shift1(x, x.ndim - 2) * mi
    xj = _shift1(x, x.ndim - 1) * mj
    xij = _shift1(_shift1(x, x.ndim - 2), x.ndim - 1) * (mi * mj)
    return x - xi - xj + xij


def _block_cumsum(a: torch.Tensor, dim: int, block: int) -> torch.Tensor:
    n = a.shape[dim]
    nb = -(-n // block)
    pad = nb * block - n
    if pad:
        shape = list(a.shape)
        shape[dim] = pad
        a = torch.cat([a, a.new_zeros(shape)], dim=dim)
    shape = list(a.shape)
    shape[dim:dim + 1] = [nb, block]
    out = torch.cumsum(a.reshape(shape), dim=dim + 1)
    shape2 = list(a.shape)
    return out.reshape(shape2).narrow(dim, 0, n)


def c2_block(r: torch.Tensor, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Tile-local 2D inclusive cumsum (inverse of d2_block)."""
    return _block_cumsum(_block_cumsum(r, r.ndim - 2, block), r.ndim - 1,
                         block)


def lorenzo_encode(x: torch.Tensor, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """res (T, H, W) int64 from X (T, H, W) int64."""
    d2 = d2_block(x, block)
    return d2 - _shift1(d2, 0)


# ----------------------------------------------------------------------
# semi-Lagrangian (plain float64)
# ----------------------------------------------------------------------

def bilinear(f: torch.Tensor, fi: torch.Tensor, fj: torch.Tensor):
    """Bilinear sample of f (..., H, W) f64 at float positions of the same
    shape (each plane sampled on its own), summed left to right as
    (1-a)(1-b) f00 + (1-a) b f01 + a (1-b) f10 + a b f11."""
    H, W = f.shape[-2:]
    i0 = torch.clamp(torch.floor(fi), 0, H - 1)
    j0 = torch.clamp(torch.floor(fj), 0, W - 1)
    a = fi - i0
    b = fj - j0
    i0 = i0.to(torch.int64)
    j0 = j0.to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=H - 1)
    j1 = torch.clamp(j0 + 1, max=W - 1)
    planes = f.reshape(-1, H * W)

    def at(i, j):
        return planes.gather(1, (i * W + j).reshape(planes.shape[0], -1)) \
            .reshape(f.shape)

    f00 = at(i0, j0)
    f01 = at(i0, j1)
    f10 = at(i1, j0)
    f11 = at(i1, j1)
    return ((1 - a) * (1 - b) * f00 + (1 - a) * b * f01
            + a * (1 - b) * f10 + a * b * f11)


def sl_predict_frame(xu_prev: torch.Tensor, xv_prev: torch.Tensor,
                     g2f: float, cfl_x: float, cfl_y: float,
                     d_max: float, n_max: int):
    """Predict frame t's base-grid integers from frame t-1's.

    xu_prev, xv_prev: (H, W) int64, or a (B, H, W) stack of independent
    frames.  Returns (pu, pv) int64 of the same shape.  The substep loop
    runs to the largest count of the stack; steps past a pixel's own
    count are masked identities, so each frame of a stack gets the
    integers it gets alone.
    """
    f64 = torch.float64
    g2 = float(g2f)
    u = xu_prev.to(f64) * g2
    v = xv_prev.to(f64) * g2
    H, W = u.shape[-2:]
    cx = float(cfl_x)
    cy = float(cfl_y)
    ii, jj = torch.meshgrid(torch.arange(H, dtype=f64, device=u.device),
                            torch.arange(W, dtype=f64, device=u.device),
                            indexing="ij")
    ii = ii.expand(u.shape)
    jj = jj.expand(u.shape)
    d_inf = torch.maximum(torch.abs(u) * cx, torch.abs(v) * cy)

    i_h = torch.clamp(ii - 0.5 * v * cy, 0.0, H - 1.0)
    j_h = torch.clamp(jj - 0.5 * u * cx, 0.0, W - 1.0)
    u_h = bilinear(u, i_h, j_h)
    v_h = bilinear(v, i_h, j_h)
    i_rk = ii - v_h * cy
    j_rk = jj - u_h * cx

    n_sub = torch.clamp(torch.ceil(d_inf / float(d_max)), 1.0, float(n_max))
    n_hi = float(n_sub.max())
    pi, pj = ii.clone(), jj.clone()
    s = 0
    while s < n_hi:
        us = bilinear(u, pi, pj)
        vs = bilinear(v, pi, pj)
        active = s < n_sub
        pi = torch.where(
            active, torch.clamp(pi - vs * cy / n_sub, 0.0, H - 1.0), pi)
        pj = torch.where(
            active, torch.clamp(pj - us * cx / n_sub, 0.0, W - 1.0), pj)
        s += 1

    use_rk = d_inf <= float(d_max)
    i_s = torch.clamp(torch.where(use_rk, i_rk, pi), 0.0, H - 1.0)
    j_s = torch.clamp(torch.where(use_rk, j_rk, pj), 0.0, W - 1.0)
    pu = bilinear(u, i_s, j_s) / g2
    pv = bilinear(v, i_s, j_s) / g2
    return torch.round(pu).to(torch.int64), torch.round(pv).to(torch.int64)
