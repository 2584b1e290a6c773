"""Data model for extracted critical-point trajectories (the JAX
package's ``analysis/model.py``, host numpy).

A *crossing node* is a face of the space-time tet mesh crossed by the
zero set of the (u, v) field, located at the barycentric zero of the
linear interpolant over the face (paper Eq. 2) -- a point (t, y, x) in
space-time.  A *segment* joins the two crossed faces of one tet (Lemma
1), and the connected components of the segment graph are the
*tracks* (critical-point trajectories).

Because a face is shared by at most two tets, every node has degree at
most 2: tracks are simple polylines (open paths) or loops.  The node
order inside each polyline is canonicalized (see ``order_component``)
so two extractions of the same field produce bit-identical polylines --
the property the feature-query roundtrip tests assert.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# critical-point type codes (classify.py)
CP_TYPES = ("saddle", "source", "sink", "spiral_in", "spiral_out",
            "center", "degenerate")
CP_CODE = {name: i for i, name in enumerate(CP_TYPES)}


def order_component(node_keys, edges):
    """Canonical node order of one track component.

    node_keys: (N,) int64 sort keys (global face ids -- unique per
    node); edges: (E, 2) int indices into the component's node array.
    Returns an int64 index permutation tracing the polyline.

    Deterministic rule: open paths start at the endpoint with the
    smaller key and walk to the other end; loops start at the node with
    the smallest key and step first toward its smaller-keyed neighbor.
    Raises if any node has degree > 2 (impossible under Lemma 1).
    """
    n = len(node_keys)
    if n == 1:
        return np.zeros(1, dtype=np.int64)
    adj = [[] for _ in range(n)]
    for a, b in np.asarray(edges):
        adj[int(a)].append(int(b))
        adj[int(b)].append(int(a))
    deg = np.array([len(a) for a in adj])
    if (deg > 2).any():
        bad = int(np.argmax(deg > 2))
        raise ValueError(
            f"crossing node {int(node_keys[bad])} has degree {deg[bad]} "
            f"> 2; the segment graph is not a union of polylines")
    ends = np.nonzero(deg <= 1)[0]
    if len(ends):
        start = ends[np.argmin(node_keys[ends])]
        nxt = adj[start][0] if adj[start] else None
    else:  # loop
        start = int(np.argmin(node_keys))
        nbrs = adj[start]
        nxt = nbrs[int(np.argmin(node_keys[nbrs]))]
    order = [int(start)]
    prev = int(start)
    cur = None if nxt is None else int(nxt)
    while cur is not None and cur != start:
        order.append(cur)
        nbrs = adj[cur]
        step = [x for x in nbrs if x != prev]
        prev, cur = cur, (step[0] if step else None)
    if len(order) != n:
        # a real raise (not assert): the walk runs over segment edges
        # that may come from a container's track-index footer, so a
        # corrupted index must fail typed -- even under python -O --
        # instead of returning a silently truncated polyline
        raise ValueError(
            f"track component is not a single path/loop: walked "
            f"{len(order)} of {n} nodes (corrupt track index?)")
    return np.asarray(order, dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class Track:
    """One critical-point trajectory (ordered polyline)."""

    track_id: int
    nodes: np.ndarray        # (N, 3) float64 (t, y, x), polyline order
    face_ids: np.ndarray     # (N,) int64 global face ids, same order
    types: np.ndarray        # (N,) int8 CP_TYPES codes, same order
    is_loop: bool

    @property
    def t_min(self) -> float:
        return float(self.nodes[:, 0].min())

    @property
    def t_max(self) -> float:
        return float(self.nodes[:, 0].max())

    @property
    def lifetime(self) -> float:
        return self.t_max - self.t_min

    def type_histogram(self) -> np.ndarray:
        return np.bincount(self.types, minlength=len(CP_TYPES))

    @property
    def dominant_type(self) -> str:
        return CP_TYPES[int(np.argmax(self.type_histogram()))]

    def events(self, T: int) -> dict:
        """Birth/death events at slab boundaries.

        A track whose first (last) node lies strictly inside the time
        domain is *born* (*dies*) there -- a genuine topology event; one
        touching t = 0 / t = T-1 merely enters/leaves the observation
        window.  Loops are born and die inside by construction.
        """
        eps = 1e-12
        return {
            "birth": "interior" if self.t_min > eps else "domain_start",
            "death": "interior" if self.t_max < T - 1 - eps
            else "domain_end",
        }


@dataclasses.dataclass(frozen=True)
class TrajectorySet:
    """All tracks of one field + flat per-node arrays.

    Flat arrays are in global node order (ascending face id); tracks
    hold the polyline-ordered views.  ``track_of`` maps flat node index
    -> dense track id.  Track ids are assigned by ascending minimum
    face id of the component, which makes them stable across host/device
    extraction and across tiled re-extraction of the same topology.
    """

    shape: tuple              # (T, H, W)
    nodes: np.ndarray         # (N, 3) float64 (t, y, x)
    face_ids: np.ndarray      # (N,) int64
    types: np.ndarray         # (N,) int8
    track_of: np.ndarray      # (N,) int32
    edges: np.ndarray         # (E, 2) int64 flat node indices
    tracks: tuple             # tuple[Track]

    @property
    def n_tracks(self) -> int:
        return len(self.tracks)

    @property
    def n_nodes(self) -> int:
        return len(self.face_ids)

    def track(self, track_id: int) -> Track:
        return self.tracks[track_id]

    def type_counts(self) -> dict:
        hist = np.bincount(self.types, minlength=len(CP_TYPES))
        return {name: int(hist[i]) for i, name in enumerate(CP_TYPES)}

    def summary(self) -> dict:
        return {
            "n_tracks": self.n_tracks,
            "n_crossing_nodes": self.n_nodes,
            "type_counts": self.type_counts(),
        }


def build_tracks(nodes, face_ids, types, track_of, edges):
    """Assemble polyline-ordered Track objects from flat arrays.

    Nodes and edges are grouped by track with one stable sort each
    (O(N log N) total; a per-track boolean scan would be O(K * N)).
    """
    n_tracks = int(track_of.max()) + 1 if len(track_of) else 0
    deg = np.bincount(edges.reshape(-1), minlength=len(face_ids)) \
        if len(edges) else np.zeros(len(face_ids), dtype=np.int64)
    node_order = np.argsort(track_of, kind="stable")
    node_ptr = np.searchsorted(track_of[node_order],
                               np.arange(n_tracks + 1))
    edge_track = track_of[edges[:, 0]] if len(edges) else \
        np.empty(0, dtype=np.int32)
    eorder = np.argsort(edge_track, kind="stable")
    edge_ptr = np.searchsorted(edge_track[eorder],
                               np.arange(n_tracks + 1))
    tracks = []
    for k in range(n_tracks):
        # stable argsort keeps the original (ascending) index order
        # within each group, so sel is sorted -- searchsorted-safe
        sel = node_order[node_ptr[k]:node_ptr[k + 1]]
        e = edges[eorder[edge_ptr[k]:edge_ptr[k + 1]]]
        local_edges = np.searchsorted(sel, e)
        order = order_component(face_ids[sel], local_edges)
        idx = sel[order]
        is_loop = bool(len(sel) > 1 and (deg[sel] == 2).all())
        tracks.append(Track(
            track_id=k,
            nodes=nodes[idx],
            face_ids=face_ids[idx],
            types=types[idx],
            is_loop=is_loop,
        ))
    return tuple(tracks)
