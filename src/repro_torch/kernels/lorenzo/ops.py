"""Dispatch of the fused dual-quantize + Lorenzo residual: a CUDA tensor
launches K1, a CPU tensor takes the plain version."""
from __future__ import annotations

import torch

from . import kernel, ref


def lorenzo_residual(dfp: torch.Tensor, k: torch.Tensor,
                     lossless: torch.Tensor, xi_unit: int,
                     block: int) -> torch.Tensor:
    if dfp.is_cuda:
        return kernel.lorenzo_residual(dfp, k, lossless, xi_unit, block)
    if dfp.device.type != "cpu":
        raise ValueError(f"no lorenzo_residual for device {dfp.device}")
    return ref.lorenzo_residual(dfp, k, lossless, xi_unit, block)
