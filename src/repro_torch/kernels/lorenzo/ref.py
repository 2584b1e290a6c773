"""Plain PyTorch version of K1: per component ``quantize.dual_quantize``
then ``predictors.lorenzo_encode`` (the transcription of the JAX
package's ``backend._lorenzo_residual_np`` and ``quantize.dual_quantize``).
Any device; int64 throughout."""
from __future__ import annotations

import torch

from ...core import predictors, quantize
from ...parallel import sharding


def lorenzo_residual(ufp: torch.Tensor, vfp: torch.Tensor, k: torch.Tensor,
                     lossless: torch.Tensor, xi_unit: int, block: int,
                     want_x: bool = False):
    """(res_u, res_v), or (res_u, res_v, xu, xv) with ``want_x``."""
    xu = quantize.dual_quantize(ufp, k, lossless, xi_unit)
    xv = quantize.dual_quantize(vfp, k, lossless, xi_unit)
    res = (predictors.lorenzo_encode(xu, block),
           predictors.lorenzo_encode(xv, block))
    return res + (xu, xv) if want_x else res


def lorenzo_residual_units(ufp: torch.Tensor, vfp: torch.Tensor,
                           k: torch.Tensor, lossless: torch.Tensor,
                           xi_unit: int, block: int, owned):
    """Per unit: X over the (Te, He, We) extension, then the Lorenzo
    residual of X's owned box (ot, oi, oj, To, Ho, Wo); stacked.  Returns
    (res_u, res_v, xu, xv)."""
    ot, oi, oj, To, Ho, Wo = (int(x) for x in owned)
    o = (slice(ot, ot + To), slice(oi, oi + Ho), slice(oj, oj + Wo))

    def one(u, v, kk, ll):
        xu = quantize.dual_quantize(u, kk, ll, xi_unit)
        xv = quantize.dual_quantize(v, kk, ll, xi_unit)
        return (predictors.lorenzo_encode(xu[o], block),
                predictors.lorenzo_encode(xv[o], block), xu, xv)

    return sharding.map_tiles(one, ufp, vfp, k, lossless)
