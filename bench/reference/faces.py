"""The plain critical-point face test: which faces of the space-time mesh
the zero set of the piecewise-linear field crosses, under Simulation of
Simplicity, in plain PyTorch int64 on any device.

The mesh (the paper's, Sec. IV): every spatial cell (i, j)-(i+1, j+1)
is cut along its main diagonal into the triangles {(i,j), (i+1,j),
(i+1,j+1)} and {(i,j), (i,j+1), (i+1,j+1)}.  Each frame's triangles are
the *slice* faces; each slab [t, t+1] adds, for every spatial edge
(p, q), the two *side* faces (p0, q0, q1) and (p0, p1, q1), and for
every triangle (a, b, c), the two *internal* faces (a0, b0, c1) and
(a0, b1, c1).  A vertex's id is t * H * W + i * W + j.

A face with values A, B, C (int64 fixed point) is crossed when the
signs of det(A, B), det(B, C) and det(C, A) agree.  A zero determinant
of vertices with ids m_A < m_B takes the first non-zero of sign(B_v),
-sign(B_u), -sign(A_v), sign(A_u), else -1 (swapped operands negate
it): the symbolic perturbation u + eps^(4^m), v + eps^(2 * 4^m).

Written from the paper and the format's documentation; it shares no
code with the program.  Fixed point: scale = 2^e with e = floor(30 -
log2(max |x|)) - 1 and x_fp = round(x * scale), half to even.
"""
from __future__ import annotations

import math

import torch

BITS = 30
# faces evaluated at once (keeps the temporaries near 1 GB at most)
FACE_BLOCK = 1 << 23


def scale_for(max_abs: float, bits: int = BITS) -> float:
    if max_abs <= 0.0 or not math.isfinite(max_abs):
        return 1.0
    return 2.0 ** (math.floor(bits - math.log2(max_abs)) - 1)


def to_fixed(x: torch.Tensor, scale: float) -> torch.Tensor:
    return torch.round(x.to(torch.float64) * scale).to(torch.int64)


def spatial_triangles(H: int, W: int, device) -> torch.Tensor:
    i = torch.arange(H - 1, device=device)[:, None]
    j = torch.arange(W - 1, device=device)[None, :]
    v00 = (i * W + j).reshape(-1)
    v01 = ((i + 1) * W + j).reshape(-1)
    v10 = (i * W + j + 1).reshape(-1)
    v11 = ((i + 1) * W + j + 1).reshape(-1)
    return torch.cat([torch.stack([v00, v01, v11], 1),
                      torch.stack([v00, v10, v11], 1)])


def spatial_edges(H: int, W: int, device) -> torch.Tensor:
    def grid(h, w):
        return (torch.arange(h, device=device)[:, None],
                torch.arange(w, device=device)[None, :])
    i, j = grid(H, W - 1)
    horiz = torch.stack([(i * W + j).reshape(-1),
                         (i * W + j + 1).reshape(-1)], 1)
    i, j = grid(H - 1, W)
    vert = torch.stack([(i * W + j).reshape(-1),
                        ((i + 1) * W + j).reshape(-1)], 1)
    i, j = grid(H - 1, W - 1)
    diag = torch.stack([(i * W + j).reshape(-1),
                        ((i + 1) * W + j + 1).reshape(-1)], 1)
    return torch.cat([horiz, vert, diag])


def face_tables(H: int, W: int, device) -> dict:
    """int64 (F, 3) vertex ids, increasing along each row: 'slice' over
    one frame, 'side' and 'internal' over one slab (ids of the upper
    frame offset by H * W)."""
    HW = H * W
    tri = spatial_triangles(H, W, device)
    e = spatial_edges(H, W, device)
    p, q = e[:, 0], e[:, 1]
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    return {
        "slice": tri,
        "side": torch.cat([torch.stack([p, q, q + HW], 1),
                           torch.stack([p, p + HW, q + HW], 1)]),
        "internal": torch.cat([torch.stack([a, b, c + HW], 1),
                               torch.stack([a, b + HW, c + HW], 1)]),
    }


def _tiebreak(au, av, bu, bv):
    s = torch.sign(bv)
    s = torch.where(s != 0, s, -torch.sign(bu))
    s = torch.where(s != 0, s, -torch.sign(av))
    s = torch.where(s != 0, s, torch.sign(au))
    return torch.where(s != 0, s, torch.full_like(s, -1))


def _sos_sign(au, av, ma, bu, bv, mb):
    s = torch.sign(au * bv - av * bu)
    tie = torch.where(ma < mb, _tiebreak(au, av, bu, bv),
                      -_tiebreak(bu, bv, au, av))
    return torch.where(s != 0, s, tie)


def crossed(u: torch.Tensor, v: torch.Tensor, ids: torch.Tensor):
    """u, v: flat int64 values; ids: (F, 3) vertex ids -> (F,) bool."""
    au, bu, cu = u[ids[:, 0]], u[ids[:, 1]], u[ids[:, 2]]
    av, bv, cv = v[ids[:, 0]], v[ids[:, 1]], v[ids[:, 2]]
    ma, mb, mc = ids[:, 0], ids[:, 1], ids[:, 2]
    s1 = _sos_sign(au, av, ma, bu, bv, mb)
    s2 = _sos_sign(bu, bv, mb, cu, cv, mc)
    s3 = _sos_sign(cu, cv, mc, au, av, ma)
    return (s1 == s2) & (s2 == s3)


def iter_predicates(ufp: torch.Tensor, vfp: torch.Tensor):
    """Yield (kind, t, crossed) over every face of a (T, H, W) int64 pair,
    a block of frames or slabs at a time: kind 'slice' with frames
    [t, t + n), 'side' / 'internal' with slabs [t, t + n); crossed is
    (n, F) bool."""
    T, H, W = ufp.shape
    HW = H * W
    tabs = face_tables(H, W, ufp.device)
    u = ufp.reshape(-1)
    v = vfp.reshape(-1)
    for kind, n_t in (("slice", T), ("side", T - 1), ("internal", T - 1)):
        tab = tabs[kind]
        step = max(1, FACE_BLOCK // len(tab))
        for t in range(0, n_t, step):
            n = min(step, n_t - t)
            ids = (tab[None] + (torch.arange(t, t + n, device=u.device)
                                * HW)[:, None, None]).reshape(-1, 3)
            yield kind, t, crossed(u, v, ids).reshape(n, len(tab))


def crossing_counts(ufp, vfp) -> dict:
    """Crossed faces by kind."""
    out = {"slice": 0, "side": 0, "internal": 0}
    for kind, _, c in iter_predicates(ufp, vfp):
        out[kind] += int(c.sum())
    return out


def plane_sizes(H: int, W: int):
    """(slice faces a frame, side + internal faces a slab) of the mesh:
    the container format numbers the faces of frame / slab t from
    t * (Fs + Fb), the slice faces first."""
    cells = (H - 1) * (W - 1)
    edges = H * (W - 1) + (H - 1) * W + cells
    return 2 * cells, 2 * edges + 4 * cells


def false_cases(ufp0, vfp0, ufp1, vfp1, planes: bool = False) -> dict:
    """Faces whose crossed state differs between two fixed-point fields
    of one shape: FC_t (slice faces) and FC_s (side + internal).  With
    ``planes``, also the second field's crossed faces a frame
    (``slice_per_frame``, T counts) and a slab (``slab_per_slab``, T - 1
    counts)."""
    T = ufp1.shape[0]
    fc = {"fc_t": 0, "fc_s": 0}
    per = {"slice": [0] * T, "slab": [0] * max(T - 1, 0)}
    for (kind, t, c0), (_, _, c1) in zip(iter_predicates(ufp0, vfp0),
                                         iter_predicates(ufp1, vfp1)):
        fc["fc_t" if kind == "slice" else "fc_s"] += int((c0 ^ c1).sum())
        if planes:
            row = per["slice" if kind == "slice" else "slab"]
            for k, n in enumerate(c1.sum(dim=1).tolist()):
                row[t + k] += int(n)
    if planes:
        fc["slice_per_frame"] = per["slice"]
        fc["slab_per_slab"] = per["slab"]
    return fc
