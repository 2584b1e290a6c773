"""Dispatch of the symbol histogram: a CUDA tensor launches K5, a CPU
tensor takes the plain version."""
from __future__ import annotations

import torch

from . import kernel, ref


def symbol_histogram(sym: torch.Tensor) -> torch.Tensor:
    if sym.is_cuda:
        return kernel.symbol_histogram(sym)
    if sym.device.type != "cpu":
        raise ValueError(f"no symbol_histogram for device {sym.device}")
    return ref.symbol_histogram(sym)
