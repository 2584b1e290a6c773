"""Compulsory bytes and operations of each kernel of the port, one file a
kernel (named after its CUDA function), and the published peaks of the
card they are held to.

Each file defines ``KERNEL`` (the CUDA function's name as the profiler
shows it, up to its argument list), ``terms(...) -> (bytes, ops)`` for
one launch, and ``launches(cfg, n, n_calls)``: the terms of the ``n``
launches a window of ``n_calls`` calls of a configuration made, as
[(terms, count)], or None where the shapes are not known.  Terms count
every input byte read once and every output byte written once, from the
shapes; operations only where the shapes fix them (the SL stepper's
depend on the data, so its operations are left out and its bound is the
bytes' bound, a lower bound).
"""
from __future__ import annotations

import importlib
from pathlib import Path

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and the rates outside the
# tensor cores of the precisions these kernels compute in
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f64": 34e12, "f32": 67e12}

HERE = Path(__file__).resolve().parent


def bound_s(nbytes: float, ops: float = 0.0, precision: str = "f64") -> float:
    """The least time the card could take: bytes over bandwidth or
    operations over the precision's peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[precision])


def faces_per_plane(H: int, W: int):
    """(slice faces a frame, side + internal faces a slab) of the mesh."""
    cells = (H - 1) * (W - 1)
    edges = H * (W - 1) + (H - 1) * W + cells
    return 2 * cells, 2 * edges + 4 * cells


def monolithic_shape(cfg: dict):
    """(T, H, W) of a cell's chunk, the shape of every launch of a
    monolithic (untiled) configuration; None for a tiled one, whose
    launches are at the unit chunks' shapes."""
    if cfg.get("tiling"):
        return None
    return cfg["chunk_frames"], cfg["field"]["H"], cfg["field"]["W"]


def kernels() -> dict:
    """{CUDA function name: module} of every kernel file here."""
    out = {}
    for path in sorted(HERE.glob("*.py")):
        if path.stem.startswith("_"):
            continue
        mod = importlib.import_module(f"{__name__}.{path.stem}")
        out[mod.KERNEL] = mod
    return out
