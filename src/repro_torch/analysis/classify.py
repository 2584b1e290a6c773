"""Critical-point classification from the interpolated Jacobian.

At a crossing node (t, y, x) the field is bilinear in space within its
cell and linear in time between the bracketing frames; the eigenvalue
structure of that interpolant's Jacobian J = [[du/dx, du/dy], [dv/dx,
dv/dy]] gives the type:

    det J < 0                      saddle
    det J > 0, tr^2 >= 4 det       source (tr > 0) / sink
    det J > 0, tr^2 <  4 det       spiral_out / spiral_in / center

with |tr| <= spiral_tol * sqrt(det) reported as center and det == 0 as
degenerate.  Host numpy float64 on the int64 fixed-point values (every
quantity is scale-invariant), op for op as in the JAX package.
"""
from __future__ import annotations

import numpy as np

from .model import CP_CODE

DEFAULT_SPIRAL_TOL = 0.05


def cell_jacobian(ufp, vfp, t, y, x):
    """(du_dx, du_dy, dv_dx, dv_dy) float64 at nodes (t, y, x).  ufp /
    vfp: (T, H, W) arrays, or anything with ``.shape`` and fancy
    indexing ``f[t_arr, i_arr, j_arr]``."""
    T, H, W = ufp.shape
    t = np.asarray(t, np.float64)
    y = np.asarray(y, np.float64)
    x = np.asarray(x, np.float64)
    t0 = np.clip(np.floor(t), 0, T - 2).astype(np.int64)
    i0 = np.clip(np.floor(y), 0, H - 2).astype(np.int64)
    j0 = np.clip(np.floor(x), 0, W - 2).astype(np.int64)
    at = t - t0
    ay = y - i0
    ax = x - j0

    def grads(f):
        c = {}
        for dt in (0, 1):
            for di in (0, 1):
                for dj in (0, 1):
                    c[dt, di, dj] = np.asarray(
                        f[t0 + dt, i0 + di, j0 + dj], np.float64)
        # blend in time first
        g = {(di, dj): (1 - at) * c[0, di, dj] + at * c[1, di, dj]
             for di in (0, 1) for dj in (0, 1)}
        d_dx = (1 - ay) * (g[0, 1] - g[0, 0]) + ay * (g[1, 1] - g[1, 0])
        d_dy = (1 - ax) * (g[1, 0] - g[0, 0]) + ax * (g[1, 1] - g[0, 1])
        return d_dx, d_dy

    du_dx, du_dy = grads(ufp)
    dv_dx, dv_dy = grads(vfp)
    return du_dx, du_dy, dv_dx, dv_dy


def classify_nodes(ufp, vfp, nodes, spiral_tol: float = DEFAULT_SPIRAL_TOL):
    """CP type codes (model.CP_TYPES) of nodes (N, 3) = (t, y, x)."""
    nodes = np.asarray(nodes, np.float64)
    if len(nodes) == 0:
        return np.empty(0, dtype=np.int8)
    du_dx, du_dy, dv_dx, dv_dy = cell_jacobian(
        ufp, vfp, nodes[:, 0], nodes[:, 1], nodes[:, 2])
    tr = du_dx + dv_dy
    det = du_dx * dv_dy - du_dy * dv_dx
    disc = tr * tr - 4.0 * det

    out = np.full(len(nodes), CP_CODE["degenerate"], dtype=np.int8)
    saddle = det < 0
    node_like = (det > 0) & (disc >= 0)
    spiral_like = (det > 0) & (disc < 0)
    out[saddle] = CP_CODE["saddle"]
    out[node_like & (tr > 0)] = CP_CODE["source"]
    out[node_like & (tr <= 0)] = CP_CODE["sink"]
    centerish = spiral_like & (np.abs(tr) <= spiral_tol * np.sqrt(
        np.maximum(det, 0.0)))
    out[spiral_like & (tr > 0)] = CP_CODE["spiral_out"]
    out[spiral_like & (tr <= 0)] = CP_CODE["spiral_in"]
    out[centerish] = CP_CODE["center"]
    return out
