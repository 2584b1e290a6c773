"""Track-aware adaptive error-bound policies (the JAX package's
``analysis/adaptive.py``).

Builds a ``core.ebpolicy.TilePolicy`` that TIGHTENS the base bound on
every policy unit a critical-point trajectory passes through (with a
one-cell/one-frame safety margin) and RELAXES it everywhere else --
the rate-allocation side of the paper's guarantee split: topology
exactness comes from the verify fixpoint regardless of the base bound,
so the policy spends bits near features without risking FC > 0.

The trajectory geometry comes from the same extraction the compressor
preserves (``analysis.extract`` over the original field's fixed-point
planes), so "near a track" is defined against exactly the features the
decoder will reproduce.  The extraction runs on ``device`` (the CUDA
device unless ``device="cpu"``).
"""
from __future__ import annotations

import numpy as np

from ..core import ebpolicy, fixedpoint
from . import extraction


def track_units(u, v, window_t: int, tile_h: int, tile_w: int,
                margin: float = 1.0, device=None,
                fixed_bits: int = fixedpoint.DEFAULT_BITS):
    """Policy-unit keys ``(wi, ti, tj)`` any trajectory touches.

    ``margin`` inflates each crossing node (in cells/frames) before
    mapping it onto the policy grid, so the one-cell/one-frame seam
    inflation of the policy resolution can never pull a relaxed bound
    onto a track vertex.
    """
    u = np.asarray(u, np.float32)
    v = np.asarray(v, np.float32)
    _, ufp, vfp = fixedpoint.to_fixed(u, v, fixed_bits)
    traj = extraction.extract(ufp, vfp, device=device, classify=False)
    nodes = np.asarray(traj.nodes, np.float64).reshape(-1, 3)
    T, H, W = u.shape
    sizes = (window_t, tile_h, tile_w)
    limits = (T - 1, H - 1, W - 1)
    keys = set()
    for t, y, x in nodes:
        ranges = []
        for c, size, hi in zip((t, y, x), sizes, limits):
            lo_cell = int(np.floor(max(c - margin, 0)))
            hi_cell = int(np.floor(min(c + margin, hi)))
            ranges.append(range(lo_cell // size, hi_cell // size + 1))
        for wi in ranges[0]:
            for ti in ranges[1]:
                for tj in ranges[2]:
                    keys.add((wi, ti, tj))
    return keys


def track_aware_policy(u, v, tight: float, relaxed: float,
                       window_t: int = 32, tile_h: int = 64,
                       tile_w: int = 64, margin: float = 1.0,
                       device=None,
                       fixed_bits: int = fixedpoint.DEFAULT_BITS):
    """Tighten-near-trajectories policy for the original field.

    Units a track passes through get base bound ``tight``; all other
    units (and the past-the-end default) get ``relaxed``.  Bounds are
    in ``cfg.eb`` units, so ``cfg.mode`` scaling applies as usual.
    """
    if not (0 < tight <= relaxed):
        raise ValueError(f"need 0 < tight <= relaxed, got "
                         f"tight={tight}, relaxed={relaxed}")
    keys = track_units(u, v, window_t, tile_h, tile_w, margin=margin,
                       device=device, fixed_bits=fixed_bits)
    return ebpolicy.TilePolicy.make(
        window_t, tile_h, tile_w, default=float(relaxed),
        values={k: float(tight) for k in keys})
