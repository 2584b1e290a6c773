"""Plain PyTorch versions of K3 and K4: the steppers of
core/predictors.py (the JAX package's three, ``SL_VARIANTS``), per frame
and over a (B, H, W) stack, and the decode of a whole field that steps
one frame by frame.  Any device.  Each takes the variant as its last
argument."""
from __future__ import annotations

import numpy as np
import torch

from ...core import predictors
from ...parallel import sharding


def sl_step(xu_prev: torch.Tensor, xv_prev: torch.Tensor, g2f: float,
            cfl_x: float, cfl_y: float, d_max: float, n_max: int,
            variant: str = "numpy"):
    return predictors.sl_predict_frame(xu_prev, xv_prev, g2f, cfl_x, cfl_y,
                                       d_max, n_max, variant)


# the plain stepper takes a (B, H, W) stack as it is
sl_step_batched = sl_step


def sl_decode(c2u: torch.Tensor, c2v: torch.Tensor, res_u: torch.Tensor,
              res_v: torch.Tensor, blockmap: torch.Tensor, flags: torch.Tensor,
              block: int, g2f: float, cfl_x: float, cfl_y: float,
              d_max: float, n_max: int, variant: str = "numpy"):
    """x_0 = c2[0]; for t >= 1, x_t = res[t] + SL(x_{t-1}) on the pixels
    of the SL blocks of a flagged frame, x_{t-1} + c2[t] elsewhere.  The
    JAX decoder's frame loop: runs of frames with no SL step are one
    prefix sum over time."""
    T, H, W = res_u.shape
    steps = np.flatnonzero(flags.cpu().numpy())
    steps = steps[steps > 0]                   # frame 0 is spatial-only
    Su = torch.cumsum(c2u, dim=0)
    Sv = torch.cumsum(c2v, dim=0)
    if not len(steps):
        return Su, Sv
    mask = blockmap.bool().repeat_interleave(block, dim=1) \
        .repeat_interleave(block, dim=2)[:, :H, :W]

    us, vs = [], []
    prev_u = prev_v = None
    cur = 0
    for t in steps:
        t = int(t)
        if t > cur:
            if cur == 0:
                seg_u, seg_v = Su[:t], Sv[:t]
            else:
                seg_u = (prev_u - Su[cur - 1])[None] + Su[cur:t]
                seg_v = (prev_v - Sv[cur - 1])[None] + Sv[cur:t]
            us.append(seg_u)
            vs.append(seg_v)
            prev_u, prev_v = seg_u[-1], seg_v[-1]
        pu, pv = sl_step(prev_u, prev_v, g2f, cfl_x, cfl_y, d_max, n_max,
                         variant)
        xu_t = torch.where(mask[t], res_u[t] + pu, prev_u + c2u[t])
        xv_t = torch.where(mask[t], res_v[t] + pv, prev_v + c2v[t])
        us.append(xu_t[None])
        vs.append(xv_t[None])
        prev_u, prev_v = xu_t, xv_t
        cur = t + 1
    if cur < T:
        us.append((prev_u - Su[cur - 1])[None] + Su[cur:])
        vs.append((prev_v - Sv[cur - 1])[None] + Sv[cur:])
    return torch.cat(us, dim=0), torch.cat(vs, dim=0)


def sl_decode_units(c2u: torch.Tensor, c2v: torch.Tensor,
                    res_u: torch.Tensor, res_v: torch.Tensor,
                    blockmap: torch.Tensor, flags: torch.Tensor, block: int,
                    g2f: float, cfl_x: float, cfl_y: float, d_max: float,
                    n_max: int, variant: str = "numpy"):
    """``sl_decode`` per unit of (B, ...) stacks, stacked."""
    def one(a, b, c, d, bm, fl):
        return sl_decode(a, b, c, d, bm, fl, block, g2f, cfl_x, cfl_y,
                         d_max, n_max, variant)

    return sharding.map_tiles(one, c2u, c2v, res_u, res_v, blockmap, flags)

