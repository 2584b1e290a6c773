"""ctypes wrappers of K1 (csrc/lorenzo.cu): fused dual-quantization +
block-local 3D Lorenzo residual of both velocity components in one
launch on the CUDA device, optionally writing the quantized fields too
(``lorenzo_residual``, one field), and the same over a stack of tile
units, X over each unit's extension and residuals over its owned box
(``lorenzo_residual_units``).

Replaces ``repro/kernels/lorenzo/kernel.py::dualquant_lorenzo_residual_pallas``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

TILE = (16, 64)              # rows, columns of one CTA's tile (lorenzo.cu)
CTAS_PER_SM = 12             # grid the run length aims at


def divisor_params(g: int):
    """(m, sh1, sh2, fast) with which the kernel divides a 32-bit n by the
    launch constant g >= 1: with t = (m * n) >> 32,
    n // g == (t + ((n - t) >> sh1)) >> sh2 for every 0 <= n < 2^32
    (Granlund and Montgomery, "Division by invariant integers using
    multiplication", 1994, figure 4.1).  fast is 0 where g >= 2^32: the
    kernel then divides every element in 64 bits."""
    g = int(g)
    if g < 1:
        raise ValueError(f"divisor {g} < 1")
    if g >= 2 ** 32:
        return 0, 0, 0, 0
    ell = (g - 1).bit_length()              # ceil(log2 g)
    m = (2 ** 32 * (2 ** ell - g)) // g + 1
    return m, min(ell, 1), max(ell - 1, 0), 1


def run_length(T: int, H: int, W: int, device) -> int:
    """Frames per CTA: the longest run (fewest re-quantized first frames)
    that still gives about CTAS_PER_SM CTAs per SM."""
    tiles = -(-H // TILE[0]) * -(-W // TILE[1])
    target = CTAS_PER_SM * _sms(device)
    return max(1, min(T, (T * tiles) // target))


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _fn():
    f = _build.load("lorenzo").lorenzo_residual_pair
    f.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_int64, ctypes.c_uint32] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def _units_fn():
    f = _build.load("lorenzo").lorenzo_residual_units
    f.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 12 + [
        ctypes.c_int64, ctypes.c_uint32] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def _check_inputs(ufp, vfp, k, lossless, ndim):
    if not ufp.is_cuda:
        raise ValueError("lorenzo_residual kernel needs CUDA tensors")
    if ufp.dtype != torch.int64 or vfp.dtype != torch.int64 \
            or k.dtype != torch.int32 or lossless.dtype != torch.bool:
        raise TypeError(f"expected int64/int64/int32/bool, got {ufp.dtype}/"
                        f"{vfp.dtype}/{k.dtype}/{lossless.dtype}")
    if ufp.ndim != ndim or any(t.shape != ufp.shape
                               for t in (vfp, k, lossless)):
        raise ValueError(f"shape mismatch: {tuple(ufp.shape)} "
                         f"{tuple(vfp.shape)} {tuple(k.shape)} "
                         f"{tuple(lossless.shape)}")
    if any(t.device != ufp.device for t in (vfp, k, lossless)):
        raise ValueError("inputs on different devices")
    if not all(t.is_contiguous() for t in (ufp, vfp, k, lossless)):
        raise ValueError("inputs must be contiguous")


def lorenzo_residual_units(ufp: torch.Tensor, vfp: torch.Tensor,
                           k: torch.Tensor, lossless: torch.Tensor,
                           xi_unit: int, block: int, owned,
                           run: int | None = None):
    """B same-signature tile units in one launch.  ufp, vfp (B, Te, He,
    We) int64 extensions, k int32, lossless bool, contiguous on one CUDA
    device; owned = (ot, oi, oj, To, Ho, Wo), the owned box inside the
    extension.  Returns int64 (res_u, res_v) (B, To, Ho, Wo) over the
    owned boxes -- Lorenzo blocks from the owned origin, the temporal
    predictor restarting at its first frame -- and (xu, xv) (B, Te, He,
    We), X over the extensions.  ``run`` as in ``lorenzo_residual``."""
    _check_inputs(ufp, vfp, k, lossless, 4)
    B, Te, He, We = ufp.shape
    ot, oi, oj, To, Ho, Wo = (int(x) for x in owned)
    block, xi_unit = int(block), int(xi_unit)
    if not (0 <= ot and ot + To <= Te and 0 <= oi and oi + Ho <= He
            and 0 <= oj and oj + Wo <= We and min(To, Ho, Wo) >= 1):
        raise ValueError(f"owned box {tuple(owned)} outside the extension "
                         f"{(Te, He, We)}")
    if block < 1 or not 1 <= xi_unit < 2 ** 62 \
            or max(B, Te, He, We) >= 2 ** 31:
        raise ValueError(f"unsupported block={block} / xi_unit={xi_unit} "
                         f"for shape {tuple(ufp.shape)}")
    res_u = torch.empty((B, To, Ho, Wo), dtype=torch.int64,
                        device=ufp.device)
    res_v = torch.empty_like(res_u)
    xu = torch.empty_like(ufp)
    xv = torch.empty_like(vfp)
    if B == 0:
        return res_u, res_v, xu, xv
    tiles = -(-He // TILE[0]) * -(-We // TILE[1])
    if run is None:
        target = CTAS_PER_SM * _sms(ufp.device)
        run = max(1, min(Te, (B * Te * tiles) // target))
    run = int(run)
    if run < 1 or B * tiles * -(-Te // run) >= 2 ** 31:
        raise ValueError(f"run {run} gives no grid for {tuple(ufp.shape)}")
    with torch.cuda.device(ufp.device):
        err = _units_fn()(ufp.data_ptr(), vfp.data_ptr(), k.data_ptr(),
                          lossless.data_ptr(), res_u.data_ptr(),
                          res_v.data_ptr(), xu.data_ptr(), xv.data_ptr(), B,
                          Te, He, We, To, Ho, Wo, ot, oi, oj, block, run,
                          xi_unit, *divisor_params(2 * xi_unit),
                          _build.stream_ptr(ufp.device))
    _build.check(err, "lorenzo_residual_units")
    _build.count(lorenzo_residual_units)
    return res_u, res_v, xu, xv


lorenzo_residual_units.launches = 0


def lorenzo_residual(ufp: torch.Tensor, vfp: torch.Tensor, k: torch.Tensor,
                     lossless: torch.Tensor, xi_unit: int, block: int,
                     want_x: bool = False, run: int | None = None):
    """ufp, vfp (T, H, W) int64, k int32 (-1 where lossless), lossless
    bool, all contiguous on one CUDA device.  Returns int64 (res_u,
    res_v), and (res_u, res_v, xu, xv) with ``want_x``.  ``run`` (frames
    per CTA) defaults to ``run_length``; it changes no output bit."""
    _check_inputs(ufp, vfp, k, lossless, 3)
    T, H, W = ufp.shape
    block, xi_unit = int(block), int(xi_unit)
    if block < 1 or not 1 <= xi_unit < 2 ** 62 or max(T, H, W) >= 2 ** 31:
        raise ValueError(f"unsupported block={block} / xi_unit={xi_unit} "
                         f"for shape {tuple(ufp.shape)}")
    res_u = torch.empty_like(ufp)
    res_v = torch.empty_like(vfp)
    xu = torch.empty_like(ufp) if want_x else None
    xv = torch.empty_like(vfp) if want_x else None
    out = (res_u, res_v, xu, xv) if want_x else (res_u, res_v)
    if ufp.numel() == 0:
        return out
    run = run_length(T, H, W, ufp.device) if run is None else int(run)
    tiles = -(-H // TILE[0]) * -(-W // TILE[1])
    if run < 1 or tiles * -(-T // run) >= 2 ** 31:
        raise ValueError(f"run {run} gives no grid for {tuple(ufp.shape)}")
    with torch.cuda.device(ufp.device):
        err = _fn()(ufp.data_ptr(), vfp.data_ptr(), k.data_ptr(),
                    lossless.data_ptr(), res_u.data_ptr(), res_v.data_ptr(),
                    xu.data_ptr() if want_x else None,
                    xv.data_ptr() if want_x else None, T, H, W, block, run,
                    xi_unit, *divisor_params(2 * xi_unit),
                    _build.stream_ptr(ufp.device))
    _build.check(err, "lorenzo_residual")
    _build.count(lorenzo_residual)
    return out


lorenzo_residual.launches = 0
