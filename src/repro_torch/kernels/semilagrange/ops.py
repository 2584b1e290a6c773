"""Dispatch of the SL stepper, per frame and over a stack: a CUDA tensor
launches K3 / K4, a CPU tensor takes the plain version."""
from __future__ import annotations

import torch

from . import kernel, ref


def sl_step(xu_prev: torch.Tensor, xv_prev: torch.Tensor, g2f: float,
            cfl_x: float, cfl_y: float, d_max: float, n_max: int):
    if xu_prev.is_cuda:
        return kernel.sl_step(xu_prev, xv_prev, g2f, cfl_x, cfl_y, d_max,
                              n_max)
    if xu_prev.device.type != "cpu":
        raise ValueError(f"no sl_step for device {xu_prev.device}")
    return ref.sl_step(xu_prev, xv_prev, g2f, cfl_x, cfl_y, d_max, n_max)


def sl_step_batched(xu_prev: torch.Tensor, xv_prev: torch.Tensor,
                    g2f: float, cfl_x: float, cfl_y: float, d_max: float,
                    n_max: int):
    if xu_prev.is_cuda:
        return kernel.sl_step_batched(xu_prev, xv_prev, g2f, cfl_x, cfl_y,
                                      d_max, n_max)
    if xu_prev.device.type != "cpu":
        raise ValueError(f"no sl_step_batched for device {xu_prev.device}")
    return ref.sl_step_batched(xu_prev, xv_prev, g2f, cfl_x, cfl_y, d_max,
                               n_max)
