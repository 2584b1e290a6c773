"""Plain PyTorch versions of K2: the face predicate (gather the face
values, then the int64 SoS predicate of core/sos.py) and the verify
round built on it, as the JAX package's ``pipeline.check_faces`` runs
it (screen or touched-face selection, the predicate on the selected
faces, compare with the original predicates, force the bad faces'
vertices), for one field or per tile unit of a stack.  Any device."""
from __future__ import annotations

import torch

from ...core import sos


def face_crossed(u_flat: torch.Tensor, v_flat: torch.Tensor,
                 verts: torch.Tensor) -> torch.Tensor:
    return sos.face_crossed_vals(u_flat[verts], v_flat[verts], verts)


def _face_all(m, tab):
    return m[:, tab[:, 0]] & m[:, tab[:, 1]] & m[:, tab[:, 2]]


def _face_any(m, tab):
    return m[:, tab[:, 0]] | m[:, tab[:, 1]] | m[:, tab[:, 2]]


def _pairs(m):
    """(T, HW) per-frame mask -> (T-1, 2 HW) per-slab mask."""
    return torch.cat([m[:-1], m[1:]], dim=1)


def _screen(T, HW, slice_tab, slab_tab, ufp, vfp, ur_fp, vr_fp):
    """Faces whose predicate COULD have flipped (sound screen): a face
    whose u- (or v-) components keep one strict sign in both the
    original and the reconstruction cannot be crossed in either."""
    masks = []
    for o, r in ((ufp, ur_fp), (vfp, vr_fp)):
        masks.append(((o > 0) & (r > 0)).reshape(T, HW))
        masks.append(((o < 0) & (r < 0)).reshape(T, HW))

    def unsafe(ms, tab):
        safe = _face_all(ms[0], tab)
        for m in ms[1:]:
            safe |= _face_all(m, tab)
        return ~safe

    return (unsafe(masks, slice_tab),
            unsafe([_pairs(m) for m in masks], slab_tab))


def selection(ur_fp, vr_fp, ufp, vfp, delta, slice_tab, slab_tab):
    """The faces a verify round re-checks, as (T, Fs) and (T-1, Fb) bool
    masks: those the screen cannot clear (``delta is None``), else those
    with a vertex in ``delta``."""
    T, H, W = ur_fp.shape
    HW = H * W
    if delta is None:
        return _screen(T, HW, slice_tab, slab_tab, ufp, vfp, ur_fp, vr_fp)
    d2 = delta.reshape(T, HW)
    return _face_any(d2, slice_tab), _face_any(_pairs(d2), slab_tab)


def verify_faces(ur_fp, vr_fp, ufp, vfp, delta, slice_tab, slab_tab,
                 slice0, slab0, forced) -> torch.Tensor:
    """See kernel.verify_faces: the same selection, predicate and forcing
    (``forced`` updated in place); returns the bad-face count as a 0-d
    int64 tensor on the fields' device."""
    HW = ur_fp.shape[1] * ur_fp.shape[2]
    sel_sl, sel_sb = selection(ur_fp, vr_fp, ufp, vfp, delta, slice_tab,
                               slab_tab)
    ts, fs = torch.nonzero(sel_sl, as_tuple=True)
    tb, fb = torch.nonzero(sel_sb, as_tuple=True)
    verts = torch.cat([slice_tab[fs] + ts[:, None] * HW,
                       slab_tab[fb] + tb[:, None] * HW], dim=0)
    orig = torch.cat([slice0[ts, fs], slab0[tb, fb]])
    bad = face_crossed(ur_fp.reshape(-1), vr_fp.reshape(-1), verts) != orig
    forced.view(-1)[verts[bad].reshape(-1)] = True
    return bad.sum()


def verify_faces_units(ur_fp, vr_fp, ufp, vfp, delta, slice_tab, slab_tab,
                       slice0, slab0, forced) -> torch.Tensor:
    """``verify_faces`` per unit of (B, ...) stacks (``forced[b]`` updated
    in place); returns the bad faces of all units as a 0-d tensor."""
    total = torch.zeros((), dtype=torch.int64, device=ur_fp.device)
    for b in range(ur_fp.shape[0]):
        total = total + verify_faces(
            ur_fp[b], vr_fp[b], None if ufp is None else ufp[b],
            None if vfp is None else vfp[b],
            None if delta is None else delta[b], slice_tab, slab_tab,
            slice0[b], slab0[b], forced[b])
    return total
