"""Dispatch of the fused dual-quantize + Lorenzo residual of both
components, of one field or of a stack of tile units: a CUDA tensor
launches K1, a CPU tensor takes the plain version."""
from __future__ import annotations

import torch

from . import kernel, ref


def lorenzo_residual(ufp: torch.Tensor, vfp: torch.Tensor, k: torch.Tensor,
                     lossless: torch.Tensor, xi_unit: int, block: int,
                     want_x: bool = False):
    if ufp.is_cuda:
        return kernel.lorenzo_residual(ufp, vfp, k, lossless, xi_unit, block,
                                       want_x)
    if ufp.device.type != "cpu":
        raise ValueError(f"no lorenzo_residual for device {ufp.device}")
    return ref.lorenzo_residual(ufp, vfp, k, lossless, xi_unit, block, want_x)


def lorenzo_residual_units(ufp: torch.Tensor, vfp: torch.Tensor,
                           k: torch.Tensor, lossless: torch.Tensor,
                           xi_unit: int, block: int, owned):
    if ufp.is_cuda:
        return kernel.lorenzo_residual_units(ufp, vfp, k, lossless, xi_unit,
                                             block, owned)
    if ufp.device.type != "cpu":
        raise ValueError(f"no lorenzo_residual_units for device {ufp.device}")
    return ref.lorenzo_residual_units(ufp, vfp, k, lossless, xi_unit, block,
                                      owned)
