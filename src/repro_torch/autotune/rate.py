"""Rate allocation: pick per-unit base bounds to hit a target ratio (the
JAX package's ``autotune/rate.py``).

``compress(..., target_ratio=...)`` lands here.  The search builds an
adaptive eb policy (core/ebpolicy.py) instead of scaling one global
bound:

1. a uniform baseline run at ``cfg.eb`` measures the starting ratio
   (if it already meets the target, it IS the result);
2. a tiled probe over the policy grid feeds ``obs.run_report``: the
   per-unit symbol counts spread the bit deficit to the target over the
   relaxable symbols, and coarsening the quantization grid by ``f``
   saves ~log2(f) bits/symbol, so the seed rung is
   ``f0 = 2**ceil(deficit_bps)``;
3. units covering an extracted critical-point trajectory are
   PROTECTED: they keep ``cfg.eb`` whatever the target (FC = 0 stays
   enforced by the verify fixpoint regardless);
4. a geometric ladder over the relax factor ``f`` re-compresses
   two-valued policies (protected at ``eb``, everything else at
   ``eb * f``) and keeps the SMALLEST f meeting the target.

Two-valued, not graded: every distinct bound adds cap planes and level
mixes whose entropy cost exceeds what graded relaxation saves.  The
ladder is walked, not bisected: ratio(f) is non-monotonic because
looser bounds widen the level ladder (``levels_for``).  The probe, the
ladder and the protected units are deterministic, so the container and
its ``rate_target`` record equal the JAX package's; the result is an
ordinary adaptive container that decodes without this module.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .. import analysis, obs
from ..core import compressor, ebpolicy, tiling


def _policy_grid(cfg, shape):
    """Policy-grid dims: the configured tiling when present, else a
    fine default (coarse policy tiles let a handful of trajectories pin
    most of the field to the tight bound)."""
    T, H, W = shape
    g = getattr(cfg, "tiling", None)
    if g is not None:
        return int(g.window_t), int(g.tile_h), int(g.tile_w)
    return (min(max(T // 2, 1), 4),
            min(H, max(8, H // 8)),
            min(W, max(8, W // 8)))


def _compress(u, v, cfg, device):
    if cfg.tiling is not None:
        return tiling.compress_tiled(u, v, cfg, cfg.tiling, device=device)
    return compressor.compress(u, v, cfg, device=device)


def compress_with_target(u, v, cfg, target_ratio: float,
                         max_relax: float = 256.0, max_iters: int = 6,
                         margin: float = 1.0, device=None):
    """Compress (u, v) on ``device`` (the CUDA device unless
    ``device="cpu"``) to at least ``target_ratio`` via adaptive per-unit
    bounds; track-covering units stay at ``cfg.eb``.

    Returns (blob, stats); stats gains a ``rate_target`` record
    (target, achieved, met flag, relax factor, protected-unit count).
    When even the best policy of the family misses the target, the
    best-ratio container found is returned with ``met=False``.
    """
    if target_ratio <= 0:
        raise ValueError(f"target_ratio must be > 0, got {target_ratio}")
    if ebpolicy.normalize(getattr(cfg, "eb_policy", None)) is not None:
        raise ValueError("compress_with_target builds the eb policy "
                         "itself; pass a config without one")
    dev = compressor.resolve_device(device)
    u = np.asarray(u, np.float32)
    v = np.asarray(v, np.float32)
    raw_bytes = u.nbytes + v.nbytes

    blob0, stats0 = _compress(u, v, cfg, dev)
    if stats0["ratio"] >= target_ratio:
        stats0["rate_target"] = {
            "target_ratio": float(target_ratio),
            "achieved_ratio": float(stats0["ratio"]),
            "met": True, "relax": 1.0, "n_protected": None,
            "uniform_ratio": float(stats0["ratio"]),
            "uniform_sufficient": True,
        }
        return blob0, stats0

    wt, th, tw = _policy_grid(cfg, u.shape)
    # per-unit symbol counts from a tiled probe over the policy grid (a
    # monolithic baseline is one unit, which tells the allocator nothing)
    probe_cfg = dataclasses.replace(
        cfg, tiling=tiling.TileGrid(tile_h=th, tile_w=tw, window_t=wt),
        track_index=False)
    probe, _ = tiling.compress_tiled(u, v, probe_cfg, probe_cfg.tiling,
                                     device=dev)
    rows = [r for r in obs.run_report(probe)["units"]
            if r["key"] is not None]
    protected = analysis.track_units(u, v, wt, th, tw, margin=margin,
                                     device=dev, fixed_bits=cfg.fixed_bits)
    free = [r for r in rows if tuple(r["key"]) not in protected]
    free_syms = sum(r["n_symbols"] for r in free)
    base = float(cfg.eb)

    # seed rung: bits we must shed to hit the target, spread over the
    # relaxable symbols; coarsening the grid by f saves ~log2(f) bps
    deficit_bits = 8.0 * (len(blob0) - raw_bytes / target_ratio)
    need_bps = deficit_bits / max(free_syms, 1)
    f0 = 2.0 ** max(2, math.ceil(need_bps))
    f0 = min(max(f0, 2.0), float(max_relax))

    def build(f):
        pol = ebpolicy.TilePolicy.make(
            wt, th, tw, default=base * f,
            values={k: base for k in protected})
        run_cfg = dataclasses.replace(
            cfg, eb_policy=pol,
            n_levels=ebpolicy.levels_for(pol, cfg.n_levels))
        blob, stats = _compress(u, v, run_cfg, dev)
        return float(f), blob, stats

    tried = {}
    best = None           # best ratio seen (fallback when target unmet)
    winner = None         # smallest f meeting the target

    def visit(f):
        nonlocal best, winner
        if f in tried:
            return tried[f]
        r = build(f)
        tried[f] = r
        if best is None or r[2]["ratio"] > best[2]["ratio"]:
            best = r
        if r[2]["ratio"] >= target_ratio and \
                (winner is None or r[0] < winner[0]):
            winner = r
        return r

    f = f0
    r = visit(f)
    if r[2]["ratio"] >= target_ratio:
        # walk down for the least-distortion rung still meeting it
        while len(tried) < max_iters and f > 2.0:
            f = f / 2.0
            if visit(f)[2]["ratio"] < target_ratio:
                break
    else:
        # walk up until the target is met or the family tops out
        while len(tried) < max_iters and f < float(max_relax):
            f = min(f * 2.0, float(max_relax))
            if visit(f)[2]["ratio"] >= target_ratio:
                break

    f, blob, stats = winner if winner is not None else best
    stats["rate_target"] = {
        "target_ratio": float(target_ratio),
        "achieved_ratio": float(stats["ratio"]),
        "met": bool(stats["ratio"] >= target_ratio),
        "relax": float(f),
        "seed_relax": float(f0),
        "rungs_tried": sorted(tried),
        "n_protected": len(protected),
        "n_units": len(rows),
        "uniform_ratio": float(stats0["ratio"]),
        "uniform_sufficient": False,
    }
    return blob, stats
