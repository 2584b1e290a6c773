"""Crossing nodes and canonical track ids (the parts of the JAX
package's ``analysis.extraction`` the track index is built from)."""
from __future__ import annotations

import numpy as np

from ..core import grid, sos


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
