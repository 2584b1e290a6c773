"""ctypes wrapper of K3 (csrc/semilagrange.cu): the per-frame f64
semi-Lagrangian stepper.

Replaces ``repro/kernels/semilagrange/kernel.py::sl_predict_pallas``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build


def _fn():
    f = _build.load("semilagrange").sl_step
    f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_double] * 4 + [ctypes.c_int, ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def sl_step(xu_prev: torch.Tensor, xv_prev: torch.Tensor, g2f: float,
            cfl_x: float, cfl_y: float, d_max: float, n_max: int):
    """xu_prev, xv_prev (H, W) int64, contiguous on one CUDA device.
    Returns (pu, pv) (H, W) int64."""
    if not xu_prev.is_cuda:
        raise ValueError("sl_step kernel needs CUDA tensors")
    for t in (xu_prev, xv_prev):
        if t.dtype != torch.int64:
            raise TypeError(f"expected int64, got {t.dtype}")
        if t.device != xu_prev.device:
            raise ValueError("inputs on different devices")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    if xu_prev.ndim != 2 or xv_prev.shape != xu_prev.shape:
        raise ValueError(f"bad shapes {tuple(xu_prev.shape)} "
                         f"{tuple(xv_prev.shape)}")
    H, W = xu_prev.shape
    pu = torch.empty_like(xu_prev)
    pv = torch.empty_like(xv_prev)
    err = _fn()(xu_prev.data_ptr(), xv_prev.data_ptr(), pu.data_ptr(),
                pv.data_ptr(), H, W, float(g2f), float(cfl_x), float(cfl_y),
                float(d_max), int(n_max), _build.stream_ptr(xu_prev.device))
    _build.check(err, "sl_step")
    sl_step.launches += 1
    return pu, pv


sl_step.launches = 0
