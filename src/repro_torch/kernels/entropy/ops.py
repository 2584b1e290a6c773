"""Dispatch of the symbol histogram: a CUDA tensor launches K5, a CPU
tensor takes the plain version."""
from __future__ import annotations

import torch

from . import kernel, ref
from .. import use_kernel


def symbol_histogram(sym: torch.Tensor) -> torch.Tensor:
    if use_kernel(sym, "symbol_histogram"):
        return kernel.symbol_histogram(sym)
    return ref.symbol_histogram(sym)
