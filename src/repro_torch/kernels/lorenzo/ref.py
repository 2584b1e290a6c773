"""Plain PyTorch version of K1 (the transcription of the JAX package's
``backend._lorenzo_residual_np``).  Any device; int64 throughout."""
from __future__ import annotations

import torch

from ...core import predictors, quantize


def lorenzo_residual(dfp: torch.Tensor, k: torch.Tensor,
                     lossless: torch.Tensor, xi_unit: int,
                     block: int) -> torch.Tensor:
    x = quantize.dual_quantize(dfp, k, lossless, xi_unit)
    return predictors.lorenzo_encode(x, block)
