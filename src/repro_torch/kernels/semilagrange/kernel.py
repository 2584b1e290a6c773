"""ctypes wrappers of K3 and K4 (csrc/semilagrange.cu): the
semi-Lagrangian decode of a whole field in one cooperative launch (K3,
``sl_decode``; ``sl_decode_units`` for a stack of same-shape tile units
in one launch) and the stepper over a stack of independent frames (K4,
``sl_step_batched``), plus the per-frame stepper ``sl_step`` that the
tests hold K4 against.

Each of K3's and K4's wrappers exists once for each stepper variant
(``core/predictors.SL_VARIANTS``): ``sl_decode`` runs the f64 "numpy"
stepper, ``sl_decode_xla`` the f64 "xla" one, ``sl_decode_pallas`` the
f32 "pallas" one, and likewise ``sl_decode_units*`` and
``sl_step_batched*``; each counts its own launches.  ``sl_step``, which
no path launches, runs the "numpy" stepper only.

Replace ``repro/kernels/semilagrange/kernel.py::sl_predict_pallas`` (as
the JAX decoder's frame loop calls it) and ``::sl_predict_batched_pallas``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ...core.predictors import SL_VARIANTS

# a variant's code in the C entries (the index of its kernel in the .cu
# file's tables) and its wrapper's name: kernel name + suffix
_CODE = {name: i for i, name in enumerate(SL_VARIANTS)}
SUFFIX = {name: "" if name == "numpy" else f"_{name}"
          for name in SL_VARIANTS}


def _fn(name: str, n_dims: int, takes_variant: bool):
    f = getattr(_build.load("semilagrange"), name)
    f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * n_dims + [
        ctypes.c_double] * 4 + [ctypes.c_int] * (1 + takes_variant) + [
        ctypes.c_void_p]
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
    Returns (pu, pv) (H, W) int64 of the "numpy" stepper."""
    _check(xu_prev, xv_prev, 2, "sl_step")
    H, W = xu_prev.shape
    pu = torch.empty_like(xu_prev)
    pv = torch.empty_like(xv_prev)
    with torch.cuda.device(xu_prev.device):
        err = _fn("sl_step", 2, False)(
            xu_prev.data_ptr(), xv_prev.data_ptr(), pu.data_ptr(),
            pv.data_ptr(), H, W, float(g2f), float(cfl_x), float(cfl_y),
            float(d_max), int(n_max), _build.stream_ptr(xu_prev.device))
    _build.check(err, "sl_step")
    _build.count(sl_step)
    return pu, pv


sl_step.launches = 0


def _step_batched(variant: str):
    name = "sl_step_batched" + SUFFIX[variant]

    def wrapper(xu_prev: torch.Tensor, xv_prev: torch.Tensor, g2f: float,
                cfl_x: float, cfl_y: float, d_max: float, n_max: int):
        _check(xu_prev, xv_prev, 3, name)
        B, H, W = xu_prev.shape
        pu = torch.empty_like(xu_prev)
        pv = torch.empty_like(xv_prev)
        if pu.numel() == 0:
            return pu, pv
        with torch.cuda.device(xu_prev.device):
            err = _fn("sl_step_batched", 3, True)(
                xu_prev.data_ptr(), xv_prev.data_ptr(), pu.data_ptr(),
                pv.data_ptr(), B, H, W, float(g2f), float(cfl_x),
                float(cfl_y), float(d_max), int(n_max), _CODE[variant],
                _build.stream_ptr(xu_prev.device))
        _build.check(err, name)
        _build.count(wrapper)
        return pu, pv

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = (
        f"""xu_prev, xv_prev (B, H, W) int64 stacks of independent frames,
    contiguous on one CUDA device.  Returns (pu, pv) (B, H, W) int64 of
    the {variant!r} stepper, each frame's as the plain stepper gives it
    (for "numpy", as ``sl_step`` does).""")
    wrapper.launches = 0
    return wrapper


sl_step_batched = _step_batched("numpy")
sl_step_batched_xla = _step_batched("xla")
sl_step_batched_pallas = _step_batched("pallas")


def _check_decode(c2u, c2v, res_u, res_v, blockmap, flags, block: int,
                  lead=()):
    planes = (c2u, c2v, res_u, res_v)
    for t in planes:
        if t.dtype != torch.int64:
            raise TypeError(f"expected int64 planes, got {t.dtype}")
    for t, what in ((blockmap, "blockmap"), (flags, "flags")):
        if t.dtype != torch.uint8:
            raise TypeError(f"expected a uint8 {what}, got {t.dtype}")
    shape = tuple(c2u.shape)
    n = len(lead)
    if len(shape) != 3 + n or shape[:n] != tuple(lead) \
            or any(tuple(t.shape) != shape for t in planes):
        raise ValueError(
            f"bad plane shapes {[tuple(t.shape) for t in planes]}")
    T, H, W = shape[n:]
    if block < 1 or H * W >= 2 ** 31:
        raise ValueError(f"bad block {block} or plane {H}x{W}")
    nb = tuple(lead) + (T, -(-H // block), -(-W // block))
    if tuple(blockmap.shape) != nb or tuple(flags.shape) != tuple(lead) \
            + (T,):
        raise ValueError(f"blockmap {tuple(blockmap.shape)} / flags "
                         f"{tuple(flags.shape)} do not fit {shape} in "
                         f"{block}-blocks: expected {nb} / "
                         f"{tuple(lead) + (T,)}")
    if not c2u.is_cuda:
        raise ValueError("sl_decode kernel needs CUDA tensors")
    for t in planes + (blockmap, flags):
        if t.device != c2u.device:
            raise ValueError("inputs on different devices")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")


def _decode_fn(name: str, n_dims: int):
    f = getattr(_build.load("semilagrange"), name)
    f.argtypes = [ctypes.c_void_p] * (8 + (name != "sl_decode")) + [
        ctypes.c_int] * n_dims + [ctypes.c_double] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def _decode(variant: str):
    name = "sl_decode" + SUFFIX[variant]

    def wrapper(c2u: torch.Tensor, c2v: torch.Tensor, res_u: torch.Tensor,
                res_v: torch.Tensor, blockmap: torch.Tensor,
                flags: torch.Tensor, block: int, g2f: float, cfl_x: float,
                cfl_y: float, d_max: float, n_max: int):
        _check_decode(c2u, c2v, res_u, res_v, blockmap, flags, int(block))
        T, H, W = c2u.shape
        xu = torch.empty_like(c2u)
        xv = torch.empty_like(c2v)
        if xu.numel() == 0:
            return xu, xv
        grid = ctypes.c_int(0)
        with torch.cuda.device(c2u.device):
            err = _decode_fn("sl_decode", 4)(
                c2u.data_ptr(), c2v.data_ptr(), res_u.data_ptr(),
                res_v.data_ptr(), blockmap.data_ptr(), flags.data_ptr(),
                xu.data_ptr(), xv.data_ptr(), T, H, W, int(block),
                float(g2f), float(cfl_x), float(cfl_y), float(d_max),
                int(n_max), _CODE[variant], ctypes.byref(grid),
                _build.stream_ptr(c2u.device))
        _build.check(err, f"{name} ({grid.value} CTAs)")
        _build.count(wrapper)
        wrapper.grid = grid.value
        return xu, xv

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = (
        f"""Decode a field's base-grid integers in one cooperative launch
    with the {variant!r} stepper.

    c2u, c2v: (T, H, W) int64 tile-local cumsums of the residuals;
    res_u, res_v: (T, H, W) int64 residuals; blockmap (T, ceil(H/block),
    ceil(W/block)) uint8, 1 for an SL block; flags (T,) uint8, 1 where
    frame t steps its SL blocks (frame 0 never does).  All contiguous on
    one CUDA device.  Returns (xu, xv) (T, H, W) int64, equal to
    ``ref.sl_decode``.  ``.grid`` is the last launch's CTA count.""")
    wrapper.launches = 0
    wrapper.grid = 0
    return wrapper


sl_decode = _decode("numpy")
sl_decode_xla = _decode("xla")
sl_decode_pallas = _decode("pallas")


def _decode_units(variant: str):
    name = "sl_decode_units" + SUFFIX[variant]

    def wrapper(c2u: torch.Tensor, c2v: torch.Tensor, res_u: torch.Tensor,
                res_v: torch.Tensor, blockmap: torch.Tensor,
                flags: torch.Tensor, block: int, g2f: float, cfl_x: float,
                cfl_y: float, d_max: float, n_max: int):
        if c2u.ndim != 4:
            raise ValueError(f"bad unit stack shape {tuple(c2u.shape)}")
        B = c2u.shape[0]
        _check_decode(c2u, c2v, res_u, res_v, blockmap, flags, int(block),
                      lead=(B,))
        _, T, H, W = c2u.shape
        xu = torch.empty_like(c2u)
        xv = torch.empty_like(c2v)
        if xu.numel() == 0:
            return xu, xv
        sync = (flags != 0).any(dim=0).to(torch.uint8).contiguous()
        grid = ctypes.c_int(0)
        with torch.cuda.device(c2u.device):
            err = _decode_fn("sl_decode_units", 5)(
                c2u.data_ptr(), c2v.data_ptr(), res_u.data_ptr(),
                res_v.data_ptr(), blockmap.data_ptr(), flags.data_ptr(),
                sync.data_ptr(), xu.data_ptr(), xv.data_ptr(), B, T, H, W,
                int(block), float(g2f), float(cfl_x), float(cfl_y),
                float(d_max), int(n_max), _CODE[variant],
                ctypes.byref(grid), _build.stream_ptr(c2u.device))
        _build.check(err, f"{name} ({grid.value} CTAs)")
        _build.count(wrapper)
        wrapper.grid = grid.value
        return xu, xv

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = (
        f"""``sl_decode`` of B same-shape tile units in one cooperative
    launch with the {variant!r} stepper: the planes (B, T, H, W),
    blockmap (B, T, ceil(H/block), ceil(W/block)) and flags (B, T)
    uint8, each unit with its own.  Returns (xu, xv) (B, T, H, W), equal
    to ``ref.sl_decode_units``.  ``.grid`` is the last launch's CTA
    count.""")
    wrapper.launches = 0
    wrapper.grid = 0
    return wrapper


sl_decode_units = _decode_units("numpy")
sl_decode_units_xla = _decode_units("xla")
sl_decode_units_pallas = _decode_units("pallas")
