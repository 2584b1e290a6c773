"""ctypes wrapper of K5 (csrc/entropy.cu): the per-row 256-bin histogram
of a (B, n) uint8 symbol stack, in one persistent launch.

Replaces ``repro/kernels/entropy/kernel.py::symbol_histogram_pallas``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

# (device index, stream handle) -> int32 workspace of the kernel: per-row
# accumulators and tickets, zero between launches (the kernel leaves them
# so).  Launches on one stream run in order, so one workspace per stream
# is never used by two launches at once.
_WORK: dict = {}


def _fn():
    f = _build.load("entropy").symbol_histogram
    f.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def _workspace(device, stream: int, B: int) -> torch.Tensor:
    key = (device.index, stream)
    work = _WORK.get(key)
    if work is None or work.numel() < B * 257:
        # zeroed once; grows with the largest B seen on this stream
        work = _WORK[key] = torch.zeros(B * 257, dtype=torch.int32,
                                        device=device)
    return work


def symbol_histogram(sym: torch.Tensor) -> torch.Tensor:
    """sym (B, n) uint8, contiguous on a CUDA device.  Returns (B, 256)
    int32 exact counts."""
    if not sym.is_cuda:
        raise ValueError("symbol_histogram kernel needs CUDA tensors")
    if sym.dtype != torch.uint8:
        raise TypeError(f"expected uint8, got {sym.dtype}")
    if not sym.is_contiguous():
        raise ValueError("input must be contiguous")
    if sym.ndim != 2 or sym.shape[0] > 65535 or sym.shape[1] >= 2 ** 31:
        raise ValueError(f"bad shape {tuple(sym.shape)}: expected (B, n) "
                         "with B <= 65535 and n < 2^31")
    B, n = sym.shape
    if B == 0 or n == 0:
        return torch.zeros((B, 256), dtype=torch.int32, device=sym.device)
    hist = torch.empty((B, 256), dtype=torch.int32, device=sym.device)
    with torch.cuda.device(sym.device):
        stream = _build.stream_ptr(sym.device)
        work = _workspace(sym.device, stream.value, B)
        err = _fn()(sym.data_ptr(), B, n, hist.data_ptr(), work.data_ptr(),
                    stream)
    _build.check(err, "symbol_histogram")
    _build.count(symbol_histogram)
    return hist


symbol_histogram.launches = 0
