"""Plain PyTorch versions of K3 and K4: the f64 stepper of
core/predictors.py (a literal transcription of the JAX package's numpy
stepper), per frame and over a (B, H, W) stack.  Any device."""
from __future__ import annotations

import torch

from ...core import predictors


def sl_step(xu_prev: torch.Tensor, xv_prev: torch.Tensor, g2f: float,
            cfl_x: float, cfl_y: float, d_max: float, n_max: int):
    return predictors.sl_predict_frame(xu_prev, xv_prev, g2f, cfl_x, cfl_y,
                                       d_max, n_max)


# the plain stepper takes a (B, H, W) stack as it is
sl_step_batched = sl_step
