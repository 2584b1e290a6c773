"""ctypes wrappers of K3 and K4 (csrc/semilagrange.cu): the f64
semi-Lagrangian stepper, per frame (K3) and over a stack of independent
frames (K4).

Replace ``repro/kernels/semilagrange/kernel.py::sl_predict_pallas`` and
``::sl_predict_batched_pallas``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build


def _fn(name: str, n_dims: int):
    f = getattr(_build.load("semilagrange"), name)
    f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * n_dims + [
        ctypes.c_double] * 4 + [ctypes.c_int, ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def _check(xu: torch.Tensor, xv: torch.Tensor, ndim: int, what: str):
    if not xu.is_cuda:
        raise ValueError(f"{what} kernel needs CUDA tensors")
    for t in (xu, xv):
        if t.dtype != torch.int64:
            raise TypeError(f"expected int64, got {t.dtype}")
        if t.device != xu.device:
            raise ValueError("inputs on different devices")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    if xu.ndim != ndim or xv.shape != xu.shape or xu.numel() >= 2 ** 31:
        raise ValueError(f"bad shapes {tuple(xu.shape)} {tuple(xv.shape)}")


def sl_step(xu_prev: torch.Tensor, xv_prev: torch.Tensor, g2f: float,
            cfl_x: float, cfl_y: float, d_max: float, n_max: int):
    """xu_prev, xv_prev (H, W) int64, contiguous on one CUDA device.
    Returns (pu, pv) (H, W) int64."""
    _check(xu_prev, xv_prev, 2, "sl_step")
    H, W = xu_prev.shape
    pu = torch.empty_like(xu_prev)
    pv = torch.empty_like(xv_prev)
    err = _fn("sl_step", 2)(
        xu_prev.data_ptr(), xv_prev.data_ptr(), pu.data_ptr(), pv.data_ptr(),
        H, W, float(g2f), float(cfl_x), float(cfl_y), float(d_max),
        int(n_max), _build.stream_ptr(xu_prev.device))
    _build.check(err, "sl_step")
    sl_step.launches += 1
    return pu, pv


sl_step.launches = 0


def sl_step_batched(xu_prev: torch.Tensor, xv_prev: torch.Tensor,
                    g2f: float, cfl_x: float, cfl_y: float, d_max: float,
                    n_max: int):
    """xu_prev, xv_prev (B, H, W) int64 stacks of independent frames,
    contiguous on one CUDA device.  Returns (pu, pv) (B, H, W) int64,
    equal to B calls of ``sl_step``."""
    _check(xu_prev, xv_prev, 3, "sl_step_batched")
    B, H, W = xu_prev.shape
    pu = torch.empty_like(xu_prev)
    pv = torch.empty_like(xv_prev)
    if pu.numel() == 0:
        return pu, pv
    err = _fn("sl_step_batched", 3)(
        xu_prev.data_ptr(), xv_prev.data_ptr(), pu.data_ptr(), pv.data_ptr(),
        B, H, W, float(g2f), float(cfl_x), float(cfl_y), float(d_max),
        int(n_max), _build.stream_ptr(xu_prev.device))
    _build.check(err, "sl_step_batched")
    sl_step_batched.launches += 1
    return pu, pv


sl_step_batched.launches = 0
