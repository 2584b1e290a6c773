"""Plain PyTorch version of K1: per component ``quantize.dual_quantize``
then ``predictors.lorenzo_encode`` (the transcription of the JAX
package's ``backend._lorenzo_residual_np`` and ``quantize.dual_quantize``).
Any device; int64 throughout."""
from __future__ import annotations

import torch

from ...core import predictors, quantize


def lorenzo_residual(ufp: torch.Tensor, vfp: torch.Tensor, k: torch.Tensor,
                     lossless: torch.Tensor, xi_unit: int, block: int,
                     want_x: bool = False):
    """(res_u, res_v), or (res_u, res_v, xu, xv) with ``want_x``."""
    xu = quantize.dual_quantize(ufp, k, lossless, xi_unit)
    xv = quantize.dual_quantize(vfp, k, lossless, xi_unit)
    res = (predictors.lorenzo_encode(xu, block),
           predictors.lorenzo_encode(xv, block))
    return res + (xu, xv) if want_x else res
