"""ctypes wrapper of K1 (csrc/lorenzo.cu): fused dual-quantization +
block-local 3D Lorenzo residual on the CUDA device.

Replaces ``repro/kernels/lorenzo/kernel.py::dualquant_lorenzo_residual_pallas``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_SMEM_MAX = 232448          # bytes of shared memory one block may use


def _fn():
    f = _build.load("lorenzo").lorenzo_residual
    f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def lorenzo_residual(dfp: torch.Tensor, k: torch.Tensor,
                     lossless: torch.Tensor, xi_unit: int,
                     block: int) -> torch.Tensor:
    """dfp (T, H, W) int64, k int32 (-1 where lossless), lossless bool,
    all contiguous on one CUDA device.  Returns int64 residual (T, H, W)."""
    if not dfp.is_cuda:
        raise ValueError("lorenzo_residual kernel needs CUDA tensors")
    if dfp.dtype != torch.int64 or k.dtype != torch.int32 \
            or lossless.dtype != torch.bool:
        raise TypeError(f"expected int64/int32/bool, got {dfp.dtype}/"
                        f"{k.dtype}/{lossless.dtype}")
    if dfp.ndim != 3 or k.shape != dfp.shape or lossless.shape != dfp.shape:
        raise ValueError(f"shape mismatch: {tuple(dfp.shape)} "
                         f"{tuple(k.shape)} {tuple(lossless.shape)}")
    if k.device != dfp.device or lossless.device != dfp.device:
        raise ValueError("inputs on different devices")
    if not (dfp.is_contiguous() and k.is_contiguous()
            and lossless.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    T, H, W = dfp.shape
    block = int(block)
    n_ctas = T * -(-H // max(block, 1)) * -(-W // max(block, 1))
    if block < 1 or 2 * block * block * 8 > _SMEM_MAX or n_ctas >= 2 ** 31:
        raise ValueError(f"unsupported block={block} for shape "
                         f"{tuple(dfp.shape)}")
    out = torch.empty_like(dfp)
    err = _fn()(dfp.data_ptr(), k.data_ptr(), lossless.data_ptr(),
                out.data_ptr(), T, H, W, int(xi_unit), block,
                _build.stream_ptr(dfp.device))
    _build.check(err, "lorenzo_residual")
    lorenzo_residual.launches += 1
    return out


lorenzo_residual.launches = 0
