"""Space-time simplicial mesh over a regular (T, H, W) grid.

Spatial triangulation: every cell (i, j)-(i+1, j+1) is split along the
main diagonal into

    tri1 = {(i, j), (i+1, j), (i+1, j+1)}
    tri2 = {(i, j), (i, j+1), (i+1, j+1)}

Face families per slab [t, t+1] (local vertex id = plane * H*W + sid,
plane in {0, 1}, sid = i * W + j):

    slice0    bottom time-slice triangles            2 (H-1)(W-1)
    side      2 per spatial edge (h, v, d edges)     2 (H(W-1) + (H-1)W + (H-1)(W-1))
    internal  2 per spatial triangle                 4 (H-1)(W-1)

Vertex ids inside a face are strictly increasing, so the SoS index
order is the id order.  The tables are built once per (H, W) with numpy
(int32, the same enumeration as the JAX package) and uploaded once per
device as int64 tensors (``device_tables``); ``face_walk`` lists the
same faces grouped by their first vertex, for the verify kernel.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def _sid(i, j, W):
    return i * W + j


@lru_cache(maxsize=32)
def spatial_triangles(H: int, W: int) -> np.ndarray:
    """(2*(H-1)*(W-1), 3) int32 sorted spatial-id triangles."""
    ii, jj = np.meshgrid(np.arange(H - 1), np.arange(W - 1), indexing="ij")
    v00 = _sid(ii, jj, W).ravel()
    v10 = _sid(ii, jj + 1, W).ravel()
    v01 = _sid(ii + 1, jj, W).ravel()
    v11 = _sid(ii + 1, jj + 1, W).ravel()
    tri1 = np.stack([v00, v01, v11], axis=1)
    tri2 = np.stack([v00, v10, v11], axis=1)
    return np.concatenate([tri1, tri2], axis=0).astype(np.int32)


@lru_cache(maxsize=32)
def spatial_edges(H: int, W: int) -> np.ndarray:
    """(E, 2) int32 sorted spatial edges: horizontal, vertical, diagonal."""
    edges = []
    ii, jj = np.meshgrid(np.arange(H), np.arange(W - 1), indexing="ij")
    edges.append(np.stack([_sid(ii, jj, W).ravel(), _sid(ii, jj + 1, W).ravel()], 1))
    ii, jj = np.meshgrid(np.arange(H - 1), np.arange(W), indexing="ij")
    edges.append(np.stack([_sid(ii, jj, W).ravel(), _sid(ii + 1, jj, W).ravel()], 1))
    ii, jj = np.meshgrid(np.arange(H - 1), np.arange(W - 1), indexing="ij")
    edges.append(np.stack([_sid(ii, jj, W).ravel(), _sid(ii + 1, jj + 1, W).ravel()], 1))
    return np.concatenate(edges, axis=0).astype(np.int32)


@lru_cache(maxsize=32)
def slab_faces(H: int, W: int):
    """Face tables for one slab, dict name -> (F, 3) int32 local ids."""
    HW = H * W
    tris = spatial_triangles(H, W).astype(np.int64)
    edges = spatial_edges(H, W).astype(np.int64)
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    p, q = edges[:, 0], edges[:, 1]
    side = np.concatenate(
        [
            np.stack([p, q, q + HW], 1),       # (p0, q0, q1)
            np.stack([p, p + HW, q + HW], 1),  # (p0, p1, q1)
        ],
        axis=0,
    )
    internal = np.concatenate(
        [
            np.stack([a, b, c + HW], 1),        # (a0, b0, c1)
            np.stack([a, b + HW, c + HW], 1),   # (a0, b1, c1)
        ],
        axis=0,
    )
    return {
        "slice0": tris.astype(np.int32),
        "slice1": (tris + HW).astype(np.int32),
        "side": side.astype(np.int32),
        "internal": internal.astype(np.int32),
    }


@lru_cache(maxsize=32)
def slab_face_table(H: int, W: int) -> np.ndarray:
    """(Fb, 3) int32 side+internal face table (local 2-plane ids)."""
    sf = slab_faces(H, W)
    return np.concatenate([sf["side"], sf["internal"]], axis=0)


@lru_cache(maxsize=32)
def incidence_table(H: int, W: int, kind: str) -> np.ndarray:
    """Static vertex -> incident (face, slot) flat-index table.

    Entry [v, k] indexes ``ebs.reshape(-1)`` (layout f*3 + slot); rows
    are padded with the out-of-range sentinel F*3, so the per-vertex eb
    reduction is a gather-min (ebound.py).
    """
    if kind == "slice":
        tab = slab_faces(H, W)["slice0"]
        n_verts = H * W
    else:
        tab = slab_face_table(H, W)
        n_verts = 2 * H * W
    F = len(tab)
    vert = tab.reshape(-1).astype(np.int64)
    order = np.argsort(vert, kind="stable")
    sv = vert[order]
    si = order.astype(np.int64)
    counts = np.bincount(sv, minlength=n_verts)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(sv)) - starts[sv]
    out = np.full((n_verts, int(counts.max())), F * 3, dtype=np.int64)
    out[sv, pos] = si
    return out


def _card(device) -> str:
    """``device`` as a cache key: ``cuda`` is the calling thread's current
    card, named ``cuda:k``, so that a worker thread of another card
    never gets this card's tables and ``cuda`` / ``cuda:0`` share one
    copy."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def device_tables(H: int, W: int, device) -> dict:
    """The face and incidence tables as int64 tensors on ``device``
    (uploaded once per (H, W, card))."""
    return _device_tables(H, W, _card(device))


# sized for several cards' geometries (a tiled window has up to four
# extension planes): an evicted table may still be read by another
# stream of its card
@lru_cache(maxsize=64)
def _device_tables(H: int, W: int, device: str) -> dict:
    dev = torch.device(device)

    def up(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

    return {
        "slice": up(slab_faces(H, W)["slice0"]),
        "slab": up(slab_face_table(H, W)),
        "slice_inc": up(incidence_table(H, W, "slice")),
        "slab_inc": up(incidence_table(H, W, "slab")),
    }


@lru_cache(maxsize=32)
def face_walk_table(H: int, W: int):
    """The slice faces and then the slab faces, grouped by the plane
    position (local id mod H W) of their first vertex: (records, start).
    records (Fs + Fb, 4) int32 rows (index, three local ids), index f for
    slice face f and Fs + f for slab face f, sorted stably by that
    position; start (H W + 1,) int32, the first record of each position.
    Every face's vertices lie in its first vertex's row or the next and
    in its column or the next (the mesh's cells), as the kernel needs."""
    hw = H * W
    tab = np.concatenate([slab_faces(H, W)["slice0"],
                          slab_face_table(H, W)]).astype(np.int64)
    first = (tab % hw).min(axis=1)
    order = np.argsort(first, kind="stable")
    records = np.concatenate([order[:, None], tab[order]], axis=1)
    start = np.concatenate([[0], np.cumsum(np.bincount(first,
                                                       minlength=hw))])
    return records.astype(np.int32), start.astype(np.int32)


def face_walk(H: int, W: int, device):
    """``face_walk_table`` as int32 tensors on ``device`` (uploaded once
    per (H, W, card), beside ``device_tables``)."""
    return _face_walk(H, W, _card(device))


@lru_cache(maxsize=64)
def _face_walk(H: int, W: int, device: str):
    dev = torch.device(device)
    return tuple(torch.as_tensor(a, device=dev)
                 for a in face_walk_table(H, W))


# ----------------------------------------------------------------------
# tetrahedra, global face ids, sub-box vertex ids (tiled containers and
# the track index)
# ----------------------------------------------------------------------
#
# Every face of the (T, H, W) mesh has one dense int64 id, interleaved
# per time step so it never depends on T:
#
#     slice faces   t * (Fs + Fb) + f          t in [0, T)
#     slab  faces   t * (Fs + Fb) + Fs + f     t in [0, T-1)
#
# with Fs = len(slice0) and Fb = len(side) + len(internal) (the
# ``slab_face_table`` order), as in the JAX package.

# the 4 faces of a tetrahedron (ids sorted: tet vertex tuples are sorted)
TET_FACES = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]],
                     dtype=np.int32)


@lru_cache(maxsize=32)
def slab_tets(H: int, W: int) -> np.ndarray:
    """(3 * n_tris, 4) int32 tetrahedra of one slab in local 2-plane ids."""
    HW = H * W
    tris = spatial_triangles(H, W).astype(np.int64)
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    tau1 = np.stack([a, b, c, c + HW], 1)
    tau2 = np.stack([a, b, b + HW, c + HW], 1)
    tau3 = np.stack([a, a + HW, b + HW, c + HW], 1)
    return np.concatenate([tau1, tau2, tau3], axis=0).astype(np.int32)


def face_family_sizes(H: int, W: int):
    """(Fs, Fb): per-slab slice-face and slab-face counts."""
    f = slab_faces(H, W)
    return len(f["slice0"]), len(f["side"]) + len(f["internal"])


def _row_lookup(table: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Index of each query row in ``table`` (every query must be a row).
    Rows are grouped by a lexicographic sort of their integer columns:
    ``np.unique(axis=0)`` would sort them as opaque bytes, tens of times
    slower on a large plane."""
    both = np.concatenate([table, queries], axis=0)
    order = np.lexsort(both.T[::-1])
    srt = both[order]
    new = np.ones(len(both), dtype=bool)
    new[1:] = (srt[1:] != srt[:-1]).any(axis=1)
    inv = np.empty(len(both), dtype=np.int64)
    inv[order] = np.cumsum(new) - 1
    pos = np.full(int(new.sum()), -1, dtype=np.int64)
    pos[inv[: len(table)]] = np.arange(len(table))
    out = pos[inv[len(table):]]
    if not (out >= 0).all():
        raise ValueError("query face not present in face table "
                         "(corrupt face ids?)")
    return out


@lru_cache(maxsize=32)
def tet_face_map(H: int, W: int):
    """Per tet-face (family, index) into the per-slab face enumeration:
    family (Ntet, 4) int8 -- 0 bottom slice, 1 top slice (indexed in the
    slice0 table), 2 slab face (indexed in ``slab_face_table``) -- and
    index (Ntet, 4) int32."""
    HW = H * W
    tets = slab_tets(H, W).astype(np.int64)
    tf = tets[:, TET_FACES]                    # (Ntet, 4, 3) local ids
    slice_tab = slab_faces(H, W)["slice0"].astype(np.int64)
    slab_tab = slab_face_table(H, W).astype(np.int64)

    plane1 = tf >= HW
    family = np.full(tf.shape[:2], 2, dtype=np.int8)
    family[~plane1.any(axis=2)] = 0
    family[plane1.all(axis=2)] = 1

    index = np.empty(tf.shape[:2], dtype=np.int32)
    flat = tf.reshape(-1, 3)
    fam_flat = family.reshape(-1)
    for fam, tab, off in ((0, slice_tab, 0), (1, slice_tab, HW),
                          (2, slab_tab, 0)):
        sel = fam_flat == fam
        if sel.any():
            index.reshape(-1)[sel] = _row_lookup(tab, flat[sel] - off)
    return family, index


def tet_face_fids(family, index, t_slab, H: int, W: int):
    """Global face ids of tet faces of slab(s) ``t_slab`` (family / index
    as ``tet_face_map`` gives them, any matching shapes)."""
    Fs, Fb = face_family_sizes(H, W)
    F = Fs + Fb
    family = np.asarray(family)
    index = np.asarray(index, dtype=np.int64)
    t = np.asarray(t_slab, dtype=np.int64)
    return np.where(family == 2, t * F + Fs + index,
                    (t + (family == 1)) * F + index)


def face_vertices(fids, H: int, W: int) -> np.ndarray:
    """Global space-time vertex ids (N, 3) of faces given by global id."""
    HW = H * W
    Fs, Fb = face_family_sizes(H, W)
    F = Fs + Fb
    slice_tab = slab_faces(H, W)["slice0"].astype(np.int64)
    slab_tab = slab_face_table(H, W).astype(np.int64)
    fids = np.asarray(fids, dtype=np.int64)
    t = fids // F
    r = fids % F
    is_slab = r >= Fs
    out = np.empty((len(fids), 3), dtype=np.int64)
    if (~is_slab).any():
        out[~is_slab] = slice_tab[r[~is_slab]] + t[~is_slab, None] * HW
    if is_slab.any():
        out[is_slab] = slab_tab[r[is_slab] - Fs] + t[is_slab, None] * HW
    return out


def box_vertex_ids(shape, box) -> np.ndarray:
    """Global flat vertex ids (t1-t0, i1-i0, j1-j0) int64 of the half-open
    sub-box ``box = (t0, t1, i0, i1, j0, j1)`` of a (T, H, W) grid.  They
    increase in the box's own row-major order, so a sub-box's local ids
    are order-isomorphic to the global ids: the SoS predicates, which
    read ids only through ``<``, are the same on a tile's extension as on
    the whole field."""
    T, H, W = shape
    t0, t1, i0, i1, j0, j1 = box
    tt = np.arange(t0, t1, dtype=np.int64)[:, None, None]
    ii = np.arange(i0, i1, dtype=np.int64)[None, :, None]
    jj = np.arange(j0, j1, dtype=np.int64)[None, None, :]
    return tt * (H * W) + ii * W + jj
