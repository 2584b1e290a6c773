"""Geometric track extraction (the JAX package's
``analysis/extraction.py``): space-time polylines and CP types.

1. every crossed face yields a crossing node at the barycentric zero of
   the face's linear interpolant (paper Eq. 2), an exact function of
   the face's three int64 vertex values;
2. the two crossed faces of each tet (Lemma 1) join into a segment
   keyed on global face ids (grid.tet_face_map);
3. ``backend.connected_labels`` labels the segment graph on the device
   (iterated min-hook + pointer jumping, exact);
4. nodes are typed from the interpolated Jacobian (classify.py) and
   assembled into a TrajectorySet of canonical polylines (model.py).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import backend, compressor, grid, sos, trajectory
from . import classify as classify_mod
from . import model


def node_positions(fids, ufp, vfp, shape):
    """(N, 3) float64 (t, y, x) barycentric crossing points of the faces
    with global ids ``fids``.  ufp / vfp: (T, H, W) int64, or anything
    with fancy indexing ``f[t_arr, i_arr, j_arr]``.  A fixed sequence of
    float64 ops on the int64 values."""
    T, H, W = shape
    HW = H * W
    verts = grid.face_vertices(fids, H, W)           # (N, 3) global ids
    tv = verts // HW
    iv = (verts % HW) // W
    jv = verts % W
    u3 = np.asarray(ufp[tv, iv, jv], np.int64)
    v3 = np.asarray(vfp[tv, iv, jv], np.int64)
    alpha, beta, gamma = sos.barycentric_crossing(u3, v3)
    w = np.stack([alpha, beta, gamma], axis=-1)
    return np.stack([(w * tv.astype(np.float64)).sum(-1),
                     (w * iv.astype(np.float64)).sum(-1),
                     (w * jv.astype(np.float64)).sum(-1)], axis=-1)


def dense_track_ids(face_ids, labels):
    """Dense track ids in ascending order of each component's minimum
    face id (labels: the component minimum's local index, as
    ``backend.connected_labels`` gives them; face_ids ascending)."""
    roots = np.unique(labels)
    remap = np.full(len(face_ids), -1, dtype=np.int32)
    remap[roots] = np.arange(len(roots), dtype=np.int32)
    return remap[labels]


def extract(ufp, vfp, device=None, tables=None, classify=True,
            spiral_tol=classify_mod.DEFAULT_SPIRAL_TOL):
    """Full geometric extraction -> model.TrajectorySet.

    ufp, vfp: (T, H, W) int64 fixed-point fields.  ``tables`` reuses
    precomputed face-predicate tables.  The predicates and the component
    labeling run on ``device`` (the CUDA device unless ``device="cpu"``);
    positions and types are host float64, op for op the reference's."""
    dev = compressor.resolve_device(device)
    ufp = np.asarray(ufp)
    vfp = np.asarray(vfp)
    T, H, W = ufp.shape
    shape = (T, H, W)
    if tables is None:
        tables = trajectory.face_predicate_tables(ufp, vfp, dev)

    family, _ = grid.tet_face_map(H, W)
    step = trajectory._frame_chunk(4 * family.shape[0])
    edge_parts = []
    for lo in range(0, T - 1, step):
        hi = min(lo + step, T - 1)
        crossed = trajectory.tet_crossings(tables, shape, lo, hi)
        edge_parts.append(trajectory.segment_edges(crossed, lo, shape))
    edges_fid = np.concatenate(edge_parts, axis=0) if edge_parts else \
        np.empty((0, 2), dtype=np.int64)

    # the sparse crossing nodes, face ids ascending
    face_ids, edges = np.unique(edges_fid, return_inverse=True)
    edges = edges.reshape(-1, 2).astype(np.int64)
    labels = backend.connected_labels(
        len(face_ids), torch.as_tensor(edges, device=dev)).cpu().numpy()
    track_of = dense_track_ids(face_ids, labels)

    nodes = node_positions(face_ids, ufp, vfp, shape)
    if classify and len(face_ids):
        types = classify_mod.classify_nodes(ufp, vfp, nodes,
                                            spiral_tol=spiral_tol)
    else:
        types = np.full(len(face_ids), model.CP_CODE["degenerate"],
                        dtype=np.int8)
    tracks = model.build_tracks(nodes, face_ids, types, track_of, edges)
    return model.TrajectorySet(
        shape=shape, nodes=nodes, face_ids=face_ids, types=types,
        track_of=track_of, edges=edges, tracks=tracks)
