"""False-case counting of critical-point trajectories (paper Sec. VII-G).

A face of the space-time mesh is crossed by the zero set iff its SoS
predicate holds (sos.py).  FC_t counts time-slice faces whose predicate
differs between the original and the reconstruction, FC_s the slab
faces; both are 0 when every trajectory is preserved.  The predicates
run as int64 torch on ``device``, independent of the kernels.
"""
from __future__ import annotations

import numpy as np
import torch

from . import fixedpoint, grid, sos

_FACE_BUDGET = 1 << 22


class Lemma1ViolationError(RuntimeError):
    """A tet with a crossed-face count outside {0, 2}: impossible under
    SoS (paper Lemma 1), so it means inconsistent predicates upstream."""


def check_lemma1(crossed, t_lo: int = 0):
    """Raise Lemma1ViolationError unless every tet has 0 or 2 crossed
    faces.  crossed: (C, Ntet, 4) bool (numpy) for slabs [t_lo, t_lo+C)."""
    n_crossed = crossed.sum(axis=2)
    bad = (n_crossed != 0) & (n_crossed != 2)
    if bad.any():
        ci, ti = np.nonzero(bad)
        raise Lemma1ViolationError(
            f"{bad.sum()} tets with crossed-face count not in {{0, 2}} "
            f"(first: slab {t_lo + int(ci[0])}, tet {int(ti[0])}, "
            f"count {int(n_crossed[ci[0], ti[0]])}); SoS predicates are "
            f"inconsistent upstream")


def face_predicate_tables(ufp, vfp, device="cpu") -> dict:
    """All face predicates: {'slice': (T, Fs) bool, 'slab': (T-1, Fb)
    bool} host numpy arrays, from int64 (T, H, W) fixed-point fields."""
    T, H, W = ufp.shape
    HW = H * W
    dev = torch.device(device)
    tabs = grid.device_tables(H, W, str(dev))
    u2 = torch.as_tensor(np.asarray(ufp, np.int64), device=dev).reshape(T, HW)
    v2 = torch.as_tensor(np.asarray(vfp, np.int64), device=dev).reshape(T, HW)
    toff = torch.arange(T, dtype=torch.int64, device=dev)[:, None, None] * HW

    def preds(pu, pv, tab, lo):
        idx = tab[None] + toff[lo:lo + pu.shape[0]]
        return sos.face_crossed_vals(pu[:, tab], pv[:, tab], idx)

    st, bt = tabs["slice"], tabs["slab"]
    step = max(1, _FACE_BUDGET // len(st))
    slice_pred = torch.cat([preds(u2[lo:lo + step], v2[lo:lo + step], st, lo)
                            for lo in range(0, T, step)])
    step = max(1, _FACE_BUDGET // len(bt))
    slab = []
    for lo in range(0, T - 1, step):
        hi = min(lo + step, T - 1)
        pu = torch.cat([u2[lo:hi], u2[lo + 1:hi + 1]], dim=1)
        pv = torch.cat([v2[lo:hi], v2[lo + 1:hi + 1]], dim=1)
        slab.append(preds(pu, pv, bt, lo))
    return {"slice": slice_pred.cpu().numpy(),
            "slab": torch.cat(slab).cpu().numpy()}


def false_cases_from_tables(p0, p1) -> dict:
    """FC_t / FC_s / CP counts from precomputed predicate tables."""
    return {
        "FC_t": int((p0["slice"] ^ p1["slice"]).sum()),
        "FC_s": int((p0["slab"] ^ p1["slab"]).sum()),
        "CP_t_orig": int(p0["slice"].sum()),
        "CP_t_rec": int(p1["slice"].sum()),
        "CP_slab_orig": int(p0["slab"].sum()),
        "CP_slab_rec": int(p1["slab"].sum()),
    }


def false_cases(u_orig, v_orig, u_rec, v_rec, scale, device="cpu") -> dict:
    """FC_t / FC_s / per-time CP counts, per the paper's metrics."""
    uo, vo = fixedpoint.refix(u_orig, v_orig, scale)
    ur, vr = fixedpoint.refix(u_rec, v_rec, scale)
    return false_cases_from_tables(face_predicate_tables(uo, vo, device),
                                   face_predicate_tables(ur, vr, device))
