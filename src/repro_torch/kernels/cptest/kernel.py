"""ctypes wrapper of K2 (csrc/cptest.cu): the exact SoS face-crossing
predicate with the vertex-value gather fused in.

Replaces ``repro/kernels/cptest/kernel.py::face_crossed_pallas``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build


def _fn():
    f = _build.load("cptest").face_crossed
    f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def face_crossed(u_flat: torch.Tensor, v_flat: torch.Tensor,
                 verts: torch.Tensor) -> torch.Tensor:
    """u_flat, v_flat (N_v,) int64 vertex values (|.| <= 2^30); verts
    (N, 3) int64 global vertex ids in [0, N_v), all contiguous on one
    CUDA device.  Returns (N,) bool."""
    if not u_flat.is_cuda:
        raise ValueError("face_crossed kernel needs CUDA tensors")
    for t in (u_flat, v_flat, verts):
        if t.dtype != torch.int64:
            raise TypeError(f"expected int64, got {t.dtype}")
        if t.device != u_flat.device:
            raise ValueError("inputs on different devices")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    if u_flat.ndim != 1 or v_flat.shape != u_flat.shape \
            or verts.ndim != 2 or verts.shape[1] != 3:
        raise ValueError(f"bad shapes {tuple(u_flat.shape)} "
                         f"{tuple(v_flat.shape)} {tuple(verts.shape)}")
    n = verts.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=u_flat.device)
    err = _fn()(u_flat.data_ptr(), v_flat.data_ptr(), verts.data_ptr(),
                out.data_ptr(), n, _build.stream_ptr(u_flat.device))
    _build.check(err, "face_crossed")
    face_crossed.launches += 1
    return out


face_crossed.launches = 0
