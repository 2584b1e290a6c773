"""Plain PyTorch version of K5: one bincount over row-offset keys (row i
counts into bins [256 i, 256 i + 256)), as the JAX package's numpy
mirror ``backend._symbol_histogram_np`` does.  Any device."""
from __future__ import annotations

import torch


def symbol_histogram(sym: torch.Tensor) -> torch.Tensor:
    B = sym.shape[0]
    rows = torch.arange(B, dtype=torch.int64, device=sym.device)[:, None]
    keys = sym.to(torch.int64) + (rows << 8)
    counts = torch.bincount(keys.reshape(-1), minlength=B * 256)
    return counts.reshape(B, 256).to(torch.int32)
