"""Dispatch of the fused dual-quantize + Lorenzo residual of both
components, of one field or of a stack of tile units: a CUDA tensor
launches K1, a CPU tensor takes the plain version."""
from __future__ import annotations

import torch

from . import kernel, ref
from .. import use_kernel


def lorenzo_residual(ufp: torch.Tensor, vfp: torch.Tensor, k: torch.Tensor,
                     lossless: torch.Tensor, xi_unit: int, block: int,
                     want_x: bool = False):
    if use_kernel(ufp, "lorenzo_residual"):
        return kernel.lorenzo_residual(ufp, vfp, k, lossless, xi_unit, block,
                                       want_x)
    return ref.lorenzo_residual(ufp, vfp, k, lossless, xi_unit, block, want_x)


def lorenzo_residual_units(ufp: torch.Tensor, vfp: torch.Tensor,
                           k: torch.Tensor, lossless: torch.Tensor,
                           xi_unit: int, block: int, owned):
    if use_kernel(ufp, "lorenzo_residual_units"):
        return kernel.lorenzo_residual_units(ufp, vfp, k, lossless, xi_unit,
                                             block, owned)
    return ref.lorenzo_residual_units(ufp, vfp, k, lossless, xi_unit, block,
                                      owned)
