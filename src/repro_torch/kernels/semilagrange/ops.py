"""Dispatch of the SL decode (K3, one field or a stack of tile units) and
of the stepper over a stack (K4) and per frame: a CUDA tensor launches
the kernel of the stepper variant (``core/predictors.SL_VARIANTS``; the
per-frame stepper has the "numpy" one only), a CPU tensor takes the
plain version."""
from __future__ import annotations

import torch

from . import kernel, ref
from .kernel import SUFFIX
from .. import use_kernel


def _wrapper(name: str, variant: str):
    return getattr(kernel, name + SUFFIX[variant])


def sl_step(xu_prev: torch.Tensor, xv_prev: torch.Tensor, g2f: float,
            cfl_x: float, cfl_y: float, d_max: float, n_max: int):
    """The "numpy" stepper over one frame."""
    args = (xu_prev, xv_prev, g2f, cfl_x, cfl_y, d_max, n_max)
    if use_kernel(xu_prev, "sl_step"):
        return kernel.sl_step(*args)
    return ref.sl_step(*args)


def sl_step_batched(xu_prev: torch.Tensor, xv_prev: torch.Tensor,
                    g2f: float, cfl_x: float, cfl_y: float, d_max: float,
                    n_max: int, variant: str = "numpy"):
    args = (xu_prev, xv_prev, g2f, cfl_x, cfl_y, d_max, n_max)
    if use_kernel(xu_prev, "sl_step_batched"):
        return _wrapper("sl_step_batched", variant)(*args)
    return ref.sl_step_batched(*args, variant)


def sl_decode(c2u: torch.Tensor, c2v: torch.Tensor, res_u: torch.Tensor,
              res_v: torch.Tensor, blockmap: torch.Tensor, flags: torch.Tensor,
              block: int, g2f: float, cfl_x: float, cfl_y: float,
              d_max: float, n_max: int, variant: str = "numpy"):
    args = (c2u, c2v, res_u, res_v, blockmap, flags, block, g2f, cfl_x,
            cfl_y, d_max, n_max)
    if use_kernel(c2u, "sl_decode"):
        return _wrapper("sl_decode", variant)(*args)
    return ref.sl_decode(*args, variant)


def sl_decode_units(c2u: torch.Tensor, c2v: torch.Tensor,
                    res_u: torch.Tensor, res_v: torch.Tensor,
                    blockmap: torch.Tensor, flags: torch.Tensor, block: int,
                    g2f: float, cfl_x: float, cfl_y: float, d_max: float,
                    n_max: int, variant: str = "numpy"):
    args = (c2u, c2v, res_u, res_v, blockmap, flags, block, g2f, cfl_x,
            cfl_y, d_max, n_max)
    if use_kernel(c2u, "sl_decode_units"):
        return _wrapper("sl_decode_units", variant)(*args)
    return ref.sl_decode_units(*args, variant)
