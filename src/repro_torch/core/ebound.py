"""Per-vertex error-bound derivation (paper Alg. 2 + Alg. 4), int64 torch.

For every triangular face of the space-time mesh Alg. 2 runs once per
vertex rotation (it bounds the perturbation of one vertex with the
other two fixed), faces already crossed by the zero set get bound 0, and
each vertex takes the minimum over its incident faces, capped at tau.
The three pairwise determinants are shared by the crossed test and the
three rotations.

Bit-equal to the JAX package's ``ebound.derive_vertex_eb``: integer
determinants, then the f64 division and ``floor`` with the relative
margin 2^-40 in the same op order (``_rotation_ebs_from_dets``), then a
gather-min over the static incidence table.  Faces are processed a few
slabs at a time in place of ``lax.scan``.

``derive_slice_eb`` is the bound of the time-slice faces alone (the
cpSZ-like baseline's), and ``all_face_predicates`` the SoS predicate of
every face through ``backend.face_crossed`` (K2 on CUDA).
"""
from __future__ import annotations

import torch

from . import backend, grid, sos

_MARGIN = 1.0 - 2.0 ** -40
_BIG = 2.0 ** 62
# faces per chunk of frames / slabs (bounds the transient (C, F, 3) gathers)
_FACE_BUDGET = 1 << 22

# the static tables, under the JAX package's names
_incidence_table = grid.incidence_table
slab_face_table = grid.slab_face_table


def _rotation_ebs_from_dets(fu, fv, crossed, d_ab, d_bc, d_ca):
    a_u, b_u, c_u = fu[..., 0], fu[..., 1], fu[..., 2]
    a_v, b_v, c_v = fv[..., 0], fv[..., 1], fv[..., 2]
    f64 = torch.float64
    m = d_ca + d_bc + d_ab
    absm = torch.abs(m).to(f64)
    big = torch.full_like(absm, _BIG)

    same_u = ((torch.sign(a_u) == torch.sign(b_u))
              & (torch.sign(b_u) == torch.sign(c_u)) & (c_u != 0))
    same_v = ((torch.sign(a_v) == torch.sign(b_v))
              & (torch.sign(b_v) == torch.sign(c_v)) & (c_v != 0))

    def rot_eb(m0, m1, pu, pv, qu, qv, su, sv):
        """Perturb vertex s with (p, q) fixed; m0 = det(s,p), m1 = det(q,s)."""
        den0 = (torch.abs(qu - pu) + torch.abs(pv - qv)).to(f64)
        den1 = (torch.abs(qu) + torch.abs(qv)).to(f64)
        den2 = (torch.abs(pu) + torch.abs(pv)).to(f64)
        eb = torch.where(den0 > 0, absm / torch.clamp(den0, min=1.0), big)
        eb = torch.minimum(
            eb, torch.abs(m1).to(f64) / torch.clamp(den1, min=1.0))
        eb = torch.minimum(
            eb, torch.abs(m0).to(f64) / torch.clamp(den2, min=1.0))
        eb = torch.where(
            same_u, torch.maximum(eb, (torch.abs(su) - 1).to(f64)), eb)
        eb = torch.where(
            same_v, torch.maximum(eb, (torch.abs(sv) - 1).to(f64)), eb)
        eb_int = torch.floor(eb * _MARGIN).to(torch.int64) - 1
        zero = (m == 0) | (den1 == 0) | (den2 == 0)
        eb_int = torch.where(zero, torch.zeros_like(eb_int), eb_int)
        return torch.clamp(eb_int, min=0)

    eb_c = rot_eb(d_ca, d_bc, a_u, a_v, b_u, b_v, c_u, c_v)
    eb_a = rot_eb(d_ab, d_ca, b_u, b_v, c_u, c_v, a_u, a_v)
    eb_b = rot_eb(d_bc, d_ab, c_u, c_v, a_u, a_v, b_u, b_v)
    ebs = torch.stack([eb_a, eb_b, eb_c], dim=-1)
    return torch.where(crossed[..., None], torch.zeros_like(ebs), ebs)


def _faces_eb_update(u_flat, v_flat, idx_base, faces, tau: int, inc):
    """Per-face bounds gather-min'd per vertex, for C planes at once.

    u_flat / v_flat (C, n) int64; idx_base (C,) int64 global id of local
    vertex 0; faces (F, 3) int64; inc (n, K) incidence table.  Returns
    (eb (C, n) int64, crossed (C, F) bool)."""
    fu = u_flat[:, faces]
    fv = v_flat[:, faces]
    fidx = faces[None] + idx_base[:, None, None]
    a_u, b_u, c_u = fu[..., 0], fu[..., 1], fu[..., 2]
    a_v, b_v, c_v = fv[..., 0], fv[..., 1], fv[..., 2]
    d_ab = a_u * b_v - a_v * b_u
    d_bc = b_u * c_v - b_v * c_u
    d_ca = c_u * a_v - c_v * a_u
    crossed = sos.face_crossed(
        a_u, a_v, fidx[..., 0], b_u, b_v, fidx[..., 1],
        c_u, c_v, fidx[..., 2], d_ab=d_ab, d_bc=d_bc, d_ca=d_ca)
    ebs = _rotation_ebs_from_dets(fu, fv, crossed, d_ab, d_bc, d_ca)
    C = ebs.shape[0]
    ebs_flat = torch.cat(
        [ebs.reshape(C, -1),
         torch.full((C, 1), 2 ** 62, dtype=torch.int64, device=ebs.device)],
        dim=1)
    out = torch.clamp(ebs_flat[:, inc].amin(dim=2), max=int(tau))
    return out, crossed


def derive_vertex_eb(ufp: torch.Tensor, vfp: torch.Tensor, tau: int):
    """Per-vertex error bounds over the full space-time mesh.

    ufp, vfp: (T, H, W) int64.  Returns (eb (T, H, W) int64,
    slice_crossed (T, Fs) bool, slab_crossed (T-1, Fb) bool).
    """
    eb, slice_c, slab_c = derive_vertex_eb_units(ufp[None], vfp[None], tau)
    return eb[0], slice_c[0], slab_c[0]


def derive_vertex_eb_units(ufp: torch.Tensor, vfp: torch.Tensor, tau: int):
    """``derive_vertex_eb`` of B same-shape fields (tile extensions)
    stacked on a leading axis, their planes processed together.  Each
    field keeps its own local vertex ids, so its results equal the
    single-field call's.  Returns (eb (B, T, H, W), slice_crossed (B, T,
    Fs), slab_crossed (B, T-1, Fb))."""
    B, T, H, W = ufp.shape
    HW = H * W
    tabs = grid.device_tables(H, W, str(ufp.device))
    u2 = ufp.reshape(B * T, HW)
    v2 = vfp.reshape(B * T, HW)
    # plane p is frame p % T of its field
    tids = (torch.arange(B * T, dtype=torch.int64, device=ufp.device) % T) \
        * HW

    eb_parts, slice_parts = [], []
    step = max(1, _FACE_BUDGET // tabs["slice"].shape[0])
    for lo in range(0, B * T, step):
        hi = min(lo + step, B * T)
        eb, crossed = _faces_eb_update(u2[lo:hi], v2[lo:hi], tids[lo:hi],
                                       tabs["slice"], tau, tabs["slice_inc"])
        eb_parts.append(eb)
        slice_parts.append(crossed)
    eb = torch.cat(eb_parts).reshape(B, T, HW)

    # slab planes: (frame t, frame t+1) pairs inside each field, built a
    # chunk at a time
    u3 = ufp.reshape(B, T, HW)
    v3 = vfp.reshape(B, T, HW)
    n_slabs = B * (T - 1)
    slab_eb, slab_parts = [], []
    step = max(1, _FACE_BUDGET // tabs["slab"].shape[0])
    for lo in range(0, n_slabs, step):
        s = torch.arange(lo, min(lo + step, n_slabs), device=ufp.device)
        b, t = s // (T - 1), s % (T - 1)
        pu = torch.cat([u3[b, t], u3[b, t + 1]], dim=1)
        pv = torch.cat([v3[b, t], v3[b, t + 1]], dim=1)
        e, crossed = _faces_eb_update(pu, pv, t * HW, tabs["slab"], tau,
                                      tabs["slab_inc"])
        slab_eb.append(e.reshape(len(s), 2, HW))
        slab_parts.append(crossed)
    if slab_eb:
        eb_slab2 = torch.cat(slab_eb).reshape(B, T - 1, 2, HW)
        # slab [t, t+1] bounds its plane-0 vertices at time t and its
        # plane-1 vertices at time t+1
        eb[:, :-1] = torch.minimum(eb[:, :-1], eb_slab2[:, :, 0])
        eb[:, 1:] = torch.minimum(eb[:, 1:], eb_slab2[:, :, 1])
        slab_c = torch.cat(slab_parts).reshape(B, T - 1, -1)
    else:
        slab_c = torch.zeros((B, 0, tabs["slab"].shape[0]), dtype=torch.bool,
                             device=ufp.device)
    return (eb.reshape(B, T, H, W), torch.cat(slice_parts).reshape(B, T, -1),
            slab_c)


def derive_slice_eb(ufp: torch.Tensor, vfp: torch.Tensor, tau: int):
    """Per-vertex bounds from the time-slice faces only (no slab faces):
    the first half of ``derive_vertex_eb``, equal to the JAX package's
    slice-only derivation of its cpSZ-like baseline.  (T, H, W) int64."""
    T, H, W = ufp.shape
    HW = H * W
    tabs = grid.device_tables(H, W, str(ufp.device))
    u2 = ufp.reshape(T, HW)
    v2 = vfp.reshape(T, HW)
    tids = torch.arange(T, dtype=torch.int64, device=ufp.device) * HW
    step = max(1, _FACE_BUDGET // tabs["slice"].shape[0])
    parts = [_faces_eb_update(u2[lo:lo + step], v2[lo:lo + step],
                              tids[lo:lo + step], tabs["slice"], tau,
                              tabs["slice_inc"])[0]
             for lo in range(0, T, step)]
    return torch.cat(parts).reshape(T, H, W)


def all_face_predicates(ufp: torch.Tensor, vfp: torch.Tensor):
    """SoS predicate of every face of the (T, H, W) int64 fields, through
    ``backend.face_crossed`` a chunk of faces at a time.  Returns (slice
    (T, Fs), slab (T-1, Fb)) bool tensors on the fields' device."""
    T, H, W = ufp.shape
    HW = H * W
    tabs = grid.device_tables(H, W, str(ufp.device))
    u_flat = ufp.reshape(-1)
    v_flat = vfp.reshape(-1)
    dev = ufp.device

    def preds(tab, n):
        step = max(1, _FACE_BUDGET // tab.shape[0])
        out = []
        for lo in range(0, n, step):
            t = torch.arange(lo, min(lo + step, n), dtype=torch.int64,
                             device=dev)
            verts = (tab[None] + (t * HW)[:, None, None]).reshape(-1, 3)
            out.append(backend.face_crossed(u_flat, v_flat, verts)
                       .reshape(len(t), -1))
        if not out:
            return torch.zeros((0, tab.shape[0]), dtype=torch.bool,
                               device=dev)
        return torch.cat(out)

    return preds(tabs["slice"], T), preds(tabs["slab"], T - 1)
