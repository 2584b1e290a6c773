"""Error-bounded gradient compression (the port of
``repro.train.grad_compress``).

Each gradient leaf is quantized to int8 in blocks of 256 elements with
one scale a block (max |g| / qmax, rounded half to even, clipped to
+-qmax) and dequantized again; with error feedback the quantization
error of a step (kept in bf16) is added to the next step's gradient.  On
one device there is no collective to shrink: the port computes the
reference's quantize-dequantize, bit for bit.  The blocks run over the
reference's leaves: the slices of a stacked leaf (one a layer in the
port) are quantized as one flat vector in layer order, so a block can
straddle two layers as it does in the reference.

On a mesh (DTensor gradients) a block can straddle two shards: each
group's gradients and residuals are gathered to whole tensors
(``full_tensor``), compressed as on one device -- the same bits -- and
each rank keeps its shards of the results (nothing more is sent).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..models.convert import stacked_groups
from ..parallel import sharding as shd

BLOCK = 256


@dataclasses.dataclass(frozen=True)
class GradCompressConfig:
    enabled: bool = False
    bits: int = 8
    error_feedback: bool = True


def init_residuals(params: dict) -> dict:
    return {n: torch.zeros_like(p, dtype=torch.bfloat16) if shd.is_sharded(p)
            else torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)
            for n, p in params.items()}


def _quant_dequant(g: torch.Tensor, bits: int):
    """Per-block symmetric int quantization of a flat leaf."""
    gf = g.float().reshape(-1)
    n = gf.numel()
    gf = F.pad(gf, (0, (-n) % BLOCK)).reshape(-1, BLOCK)
    qmax = 2.0 ** (bits - 1) - 1.0
    # max|g| / qmax as the reference computes it under jit: XLA turns the
    # division by the constant into a product with its f32 reciprocal
    scale = torch.clamp(gf.abs().amax(dim=1, keepdim=True) * (1.0 / qmax),
                        min=1e-30)
    q = torch.clamp(torch.round(gf / scale), -qmax, qmax).to(torch.int8)
    deq = q.float() * scale
    return deq.reshape(-1)[:n].reshape(g.shape), (q, scale)


def _residual(gin: torch.Tensor, codes) -> torch.Tensor:
    """gin - q * scale in bf16, with the product and the difference
    rounded once, as the reference computes it under jit (XLA fuses them
    into one FMA).  In f64 the difference is exact whenever q != 0
    (|gin| >= scale / 2 then), so one rounding to f32 follows."""
    q, scale = codes
    n = gin.numel()
    exact = gin.double().reshape(-1) \
        - (q.double() * scale.double()).reshape(-1)[:n]
    return exact.float().to(torch.bfloat16)


def compress_grads(grads: dict, residuals: dict, cfg: GradCompressConfig):
    """Returns (decompressed grads, new residuals, metrics)."""
    if cfg.enabled and shd.is_sharded(*grads.values()):
        return _compress_sharded(grads, residuals, cfg)
    if not cfg.enabled:
        dev = next(iter(grads.values())).device
        return grads, residuals, {
            "gc_error": torch.zeros((), dtype=torch.float32, device=dev)}
    new_g, new_r = {}, {}
    err = 0
    for group in stacked_groups(grads):
        g = torch.cat([grads[n].reshape(-1) for n in group])
        gin = g.float()
        if cfg.error_feedback:
            gin = gin + torch.cat([residuals[n].reshape(-1)
                                   for n in group]).float()
        deq, codes = _quant_dequant(gin, cfg.bits)
        res = _residual(gin, codes) if cfg.error_feedback else None
        deq = deq.to(g.dtype)
        err = err + (deq.float() - g.float()).abs().sum()
        start = 0
        for n in group:
            size = grads[n].numel()
            shape = grads[n].shape
            new_g[n] = deq[start:start + size].reshape(shape)
            new_r[n] = res[start:start + size].reshape(shape) \
                if res is not None else residuals[n]
            start += size
    return new_g, new_r, {"gc_error": err}


def _compress_sharded(grads: dict, residuals: dict, cfg: GradCompressConfig):
    """``compress_grads`` of DTensor gradients (module docstring): the
    results placed as the residuals (the parameters' placements)."""
    def full(tree):
        return {n: t.full_tensor() if shd.is_sharded(t) else t
                for n, t in tree.items()}

    def placed(tree):
        return {n: shd.place(t, shd.spec_of(residuals[n]),
                             residuals[n].device_mesh)
                for n, t in tree.items()}

    new_g, new_r, metrics = compress_grads(full(grads), full(residuals), cfg)
    return placed(new_g), placed(new_r), metrics
