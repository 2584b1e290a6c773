"""Evaluation metrics (paper Sec. VII-C): ratio, PSNR, max error and the
trajectory false cases."""
from __future__ import annotations

import numpy as np

from . import trajectory


def compression_ratio(orig_bytes: int, comp_bytes: int) -> float:
    return orig_bytes / max(comp_bytes, 1)


def psnr(u, v, u_rec, v_rec) -> float:
    """PSNR = 20 log10(range) - 10 log10(MSE), over both components."""
    d = np.concatenate([
        (np.asarray(u, np.float64) - np.asarray(u_rec, np.float64)).ravel(),
        (np.asarray(v, np.float64) - np.asarray(v_rec, np.float64)).ravel(),
    ])
    mse = float(np.mean(d * d))
    vals = np.concatenate([np.asarray(u).ravel(), np.asarray(v).ravel()])
    rng = float(vals.max() - vals.min())
    if mse == 0.0:
        return float("inf")
    return 20.0 * np.log10(max(rng, 1e-300)) - 10.0 * np.log10(mse)


def max_abs_error(u, v, u_rec, v_rec) -> float:
    return float(max(
        np.abs(np.asarray(u, np.float64) - np.asarray(u_rec, np.float64)).max(),
        np.abs(np.asarray(v, np.float64) - np.asarray(v_rec, np.float64)).max(),
    ))


def evaluate(u, v, u_rec, v_rec, scale, orig_bytes, comp_bytes,
             device="cpu") -> dict:
    """CR, PSNR, max error, FC_t, FC_s (trajectory counts are not ported:
    ROADMAP Queue 1 item 9)."""
    out = {
        "CR": compression_ratio(orig_bytes, comp_bytes),
        "PSNR": psnr(u, v, u_rec, v_rec),
        "max_err": max_abs_error(u, v, u_rec, v_rec),
    }
    out.update(trajectory.false_cases(u, v, u_rec, v_rec, scale, device))
    return out
