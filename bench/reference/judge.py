"""Judge a reconstruction against the original chunk by the two
guarantees the configuration states: every value within the pointwise
bound, and every critical-point trajectory kept (FC_t = FC_s = 0).

Plain PyTorch on any device; reads the original (made by the benchmark)
and the program's output, nothing else of the program.  The bound is
``eb`` times the value range for the relative mode, the range taken as
the difference of the float32 extremes over both components, as the
format defines it; the fixed point is that of ``faces``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import faces


def eb_abs(u: np.ndarray, v: np.ndarray, eb: float, mode: str) -> float:
    if mode == "abs":
        return float(eb)
    lo = np.float32(min(u.min(), v.min()))
    hi = np.float32(max(u.max(), v.max()))
    return float(eb) * max(float(hi - lo), 1e-30)


def judge(u, v, ur, vr, eb: float, mode: str, device,
          planes: bool = False) -> dict:
    """u, v: original (T, H, W) float32 numpy; ur, vr: reconstruction.
    Returns {shape_ok, max_err_over_eb, fc_t, fc_s}, and with ``planes``
    the reconstruction's crossed faces a frame and a slab
    (``faces.false_cases``)."""
    if ur is None or np.shape(ur) != u.shape or np.shape(vr) != v.shape:
        return {"shape_ok": False, "max_err_over_eb": float("inf"),
                "fc_t": -1, "fc_s": -1}
    bound = eb_abs(u, v, eb, mode)
    t = {k: torch.as_tensor(np.ascontiguousarray(a), device=device)
         for k, a in (("u", u), ("v", v), ("ur", ur), ("vr", vr))}
    err = max(float((t["ur"].double() - t["u"].double()).abs().max()),
              float((t["vr"].double() - t["v"].double()).abs().max()))
    if not np.isfinite(err):
        err = float("inf")
    max_abs = max(float(t["u"].abs().max()), float(t["v"].abs().max()),
                  1e-300)
    scale = faces.scale_for(max_abs)
    fc = faces.false_cases(faces.to_fixed(t["u"], scale),
                           faces.to_fixed(t["v"], scale),
                           faces.to_fixed(t["ur"], scale),
                           faces.to_fixed(t["vr"], scale), planes)
    return {"shape_ok": True, "max_err_over_eb": err / bound, **fc}
