"""Evaluation metrics (paper Sec. VII-C): ratio, PSNR, max error, the
trajectory false cases and the track counts."""
from __future__ import annotations

import numpy as np

from . import compressor, fixedpoint, trajectory


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
             with_tracks: bool = True, device=None) -> dict:
    """CR, PSNR, max error, FC_t, FC_s and, with ``with_tracks``, the
    track counts of both fields (#Traj, ``n_traj_orig`` / ``n_traj_rec``).
    The predicate tables of each field are built once, on ``device`` (the
    CUDA device unless ``device="cpu"``), and serve both the false cases
    and the track counts."""
    dev = compressor.resolve_device(device)
    out = {
        "CR": compression_ratio(orig_bytes, comp_bytes),
        "PSNR": psnr(u, v, u_rec, v_rec),
        "max_err": max_abs_error(u, v, u_rec, v_rec),
    }
    uo, vo = fixedpoint.refix(u, v, scale)
    ur, vr = fixedpoint.refix(u_rec, v_rec, scale)
    p0 = trajectory.face_predicate_tables(uo, vo, dev)
    p1 = trajectory.face_predicate_tables(ur, vr, dev)
    out.update(trajectory.false_cases_from_tables(p0, p1))
    if with_tracks:
        out["n_traj_orig"] = trajectory.extract_tracks(
            uo, vo, tables=p0, device=dev)["n_tracks"]
        out["n_traj_rec"] = trajectory.extract_tracks(
            ur, vr, tables=p1, device=dev)["n_tracks"]
    return out
