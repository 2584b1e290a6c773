"""Dispatch of the hot ops of the pipeline.

The tensor's device picks the implementation: on a CUDA tensor each op
launches its hand-written Hopper kernel (``repro_torch/kernels``), on a
CPU tensor it runs the kernel's plain PyTorch version.  There is no
backend name and no fallback between the two.

Determinism contract:

* the integer ops (Lorenzo residual, SoS predicate, symbol histogram)
  are exact and equal on every device;
* the SL stepper is f64 with every operation rounded once, in the op
  order of the JAX package's numpy stepper: kernel and plain version are
  bitwise equal to that stepper, so the header records
  ``sl_backend: "numpy"`` and the JAX package replays the same
  predictions when it decodes a port container.  The per-frame (K3)
  and batched (K4) kernels share one device function, so predicting the
  encoder's T-1 frames in one batched call changes no integer.
"""
from __future__ import annotations

import torch

from ..kernels.cptest import ops as _cp_ops
from ..kernels.entropy import ops as _ent_ops
from ..kernels.lorenzo import ops as _lz_ops
from ..kernels.semilagrange import ops as _sl_ops

# the header tag of the SL stepper this package runs (see module doc)
SL_BACKEND = "numpy"
# f64 steppers whose containers this package decodes with its own
SL_DECODABLE = ("numpy", "xla")


def lorenzo_residual(dfp, k, lossless, xi_unit: int, block: int):
    """Fused eb-quantize + dual-quantize + 3D-Lorenzo residual.

    dfp (T, H, W) int64; k int32 (-1 lossless); lossless bool.  Returns
    int64 residuals (T, H, W)."""
    return _lz_ops.lorenzo_residual(dfp.contiguous(),
                                    k.to(torch.int32).contiguous(),
                                    lossless.contiguous(), xi_unit, block)


def sl_stepper(cfl_x: float, cfl_y: float, d_max: float, n_max: int):
    """The per-frame SL prediction F(xu_prev, xv_prev, g2f) -> (pu, pv)
    of the verify simulation and the decoder, which step frames in
    sequence."""
    def step(xu_prev, xv_prev, g2f):
        return _sl_ops.sl_step(xu_prev.contiguous(), xv_prev.contiguous(),
                               g2f, cfl_x, cfl_y, d_max, n_max)
    return step


def sl_predictions(xu, xv, g2f: float, cfl_x: float, cfl_y: float,
                   d_max: float, n_max: int):
    """Encoder-side predictions of frames 1..T-1 from frames 0..T-2 of the
    known (T, H, W) fields, in one batched stepper call.  Returns
    (T-1, H, W) int64 stacks."""
    return _sl_ops.sl_step_batched(xu[:-1].contiguous(),
                                   xv[:-1].contiguous(), g2f, cfl_x, cfl_y,
                                   d_max, n_max)


def face_crossed(u_flat, v_flat, verts):
    """Exact SoS predicate of the faces ``verts`` (N, 3) global vertex
    ids, gathered from the flat value arrays.  Returns (N,) bool."""
    return _cp_ops.face_crossed(u_flat.contiguous(), v_flat.contiguous(),
                                verts.contiguous())


def symbol_histogram(sym):
    """Per-row 256-bin histogram of a (B, n) uint8 symbol stack.  Returns
    (B, 256) int32 exact counts."""
    return _ent_ops.symbol_histogram(sym.contiguous())
