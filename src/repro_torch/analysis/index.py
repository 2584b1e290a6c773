"""CPTT1 sidecar track index: per-unit segments, global track ids (the
JAX package's ``analysis/index.py``).

Built during tiled compression and stored in the container's footer
under ``encode.TRACK_INDEX_KEY`` with its own version.  Per (tile,
window) unit it records the zero-set segments of the tets the unit owns
as pairs of global face ids plus the tet's anchor cell; tet ownership
partitions all tets and face ids are canonical, so concatenating the
units' lists and labeling connected components stitches tracks across
seams exactly.  Per track it stores lifetime, bbox, node count, a
CP-type histogram and the units covering its inflated cells.  Track ids
ascend with the component's minimum face id.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import backend as backend_mod
from ..core import compressor, encode
from . import classify as classify_mod
from .extraction import dense_track_ids
from .model import CP_TYPES

TRACK_INDEX_VERSION = 1

_ARRAY_FIELDS = (
    "unit_keys", "unit_seg_ptr", "seg_fid", "seg_cell", "seg_track",
    "track_t_min", "track_t_max", "track_bbox", "track_n_nodes",
    "track_type_hist", "track_cover_ptr", "track_cover_unit",
)


def unit_key_of(t, i, j, tgrid):
    """(wi, ti, tj) unit key owning grid point(s) (t, i, j)."""
    return (np.asarray(t) // tgrid.window_t,
            np.asarray(i) // tgrid.tile_h,
            np.asarray(j) // tgrid.tile_w)


def encode_unit_key(wi, ti, tj, nti, ntj):
    return (np.asarray(wi) * nti + np.asarray(ti)) * ntj + np.asarray(tj)


def _cover_points(cells, shape):
    """(M, 27, 3) int64 grid points a track decode may gather per segment
    cell: t..t+2 x i..i+2 x j..j+2, clamped to the grid (a node on a cell
    boundary classifies in the next cell)."""
    T, H, W = shape
    cells = np.asarray(cells, np.int64)
    d = np.stack(np.meshgrid(*([np.arange(3)] * 3), indexing="ij"),
                 axis=-1).reshape(-1, 3)                  # (27, 3)
    pts = cells[:, None, :] + d[None, :, :]
    return np.minimum(pts, np.asarray([T - 1, H - 1, W - 1]))


class TrackIndexBuilder:
    """Accumulates per-unit segment records (``add_unit``, once per
    emitted unit, in emission order) and builds the footer section
    (``finalize``).  The component labeling runs on ``device`` (None:
    the CUDA device; RuntimeError without one)."""

    def __init__(self, tgrid, device=None,
                 spiral_tol: float = classify_mod.DEFAULT_SPIRAL_TOL):
        self.tgrid = tgrid
        self.device = compressor.resolve_device(device)
        self.spiral_tol = float(spiral_tol)
        self._keys = []
        self._seg_fid = []
        self._seg_cell = []
        self._node_fid = []
        self._node_pos = []
        self._node_type = []

    def add_unit(self, key, seg_fid, seg_cell, node_fid, node_pos,
                 node_type):
        self._keys.append([int(k) for k in key])
        self._seg_fid.append(np.asarray(seg_fid, np.int64).reshape(-1, 2))
        self._seg_cell.append(np.asarray(seg_cell, np.int32).reshape(-1, 3))
        self._node_fid.append(np.asarray(node_fid, np.int64))
        self._node_pos.append(
            np.asarray(node_pos, np.float64).reshape(-1, 3))
        self._node_type.append(np.asarray(node_type, np.int8))

    def finalize(self, shape) -> dict:
        """Global stitch + summaries -> the msgpack-able footer section
        for the final (T, H, W)."""
        T, H, W = (int(s) for s in shape)
        g = self.tgrid
        nwi = -(-T // g.window_t)
        nti = -(-H // g.tile_h)
        ntj = -(-W // g.tile_w)
        U = len(self._keys)
        seg_fid = np.concatenate(self._seg_fid, 0) if U else \
            np.empty((0, 2), np.int64)
        seg_cell = np.concatenate(self._seg_cell, 0) if U else \
            np.empty((0, 3), np.int32)
        counts = np.array([len(s) for s in self._seg_fid], np.int64)
        unit_seg_ptr = np.zeros(U + 1, np.int64)
        unit_seg_ptr[1:] = np.cumsum(counts)

        # global stitch: one component labeling over all segments
        face_ids, edges = np.unique(seg_fid, return_inverse=True)
        edges = edges.reshape(-1, 2).astype(np.int64)
        labels = backend_mod.connected_labels(
            len(face_ids), torch.as_tensor(edges, device=self.device)
        ).cpu().numpy()
        track_of_face = dense_track_ids(face_ids, labels)
        seg_track = track_of_face[
            np.searchsorted(face_ids, seg_fid[:, 0])].astype(np.int32)
        K = int(track_of_face.max()) + 1 if len(face_ids) else 0

        # node summaries, deduplicated by face id (both units of a seam
        # face record it with equal values)
        if U and sum(len(n) for n in self._node_fid):
            nf = np.concatenate(self._node_fid)
            npos = np.concatenate(self._node_pos, 0)
            ntyp = np.concatenate(self._node_type)
            _, first = np.unique(nf, return_index=True)
            nf, npos, ntyp = nf[first], npos[first], ntyp[first]
        else:
            nf = np.empty(0, np.int64)
            npos = np.empty((0, 3), np.float64)
            ntyp = np.empty(0, np.int8)
        if not np.array_equal(nf, face_ids):
            raise RuntimeError(
                "node records do not match the stitched segment faces")
        tr = track_of_face

        track_t_min = np.full(K, np.inf)
        track_t_max = np.full(K, -np.inf)
        track_bbox = np.stack([np.full(K, np.inf), np.full(K, -np.inf),
                               np.full(K, np.inf), np.full(K, -np.inf)], 1)
        np.minimum.at(track_t_min, tr, npos[:, 0])
        np.maximum.at(track_t_max, tr, npos[:, 0])
        np.minimum.at(track_bbox[:, 0], tr, npos[:, 1])
        np.maximum.at(track_bbox[:, 1], tr, npos[:, 1])
        np.minimum.at(track_bbox[:, 2], tr, npos[:, 2])
        np.maximum.at(track_bbox[:, 3], tr, npos[:, 2])
        track_n_nodes = np.bincount(tr, minlength=K).astype(np.int32)
        track_type_hist = np.zeros((K, len(CP_TYPES)), np.int32)
        np.add.at(track_type_hist, (tr, ntyp.astype(np.int64)), 1)

        # covering units per track (sorted unique, CSR)
        pts = _cover_points(seg_cell, (T, H, W)).reshape(-1, 3)
        wi, ti, tj = unit_key_of(pts[:, 0], pts[:, 1], pts[:, 2], g)
        enc = encode_unit_key(wi, ti, tj, nti, ntj)
        pair = np.stack(
            [np.repeat(seg_track.astype(np.int64), 27), enc], 1)
        pair = np.unique(pair, axis=0)
        track_cover_ptr = np.zeros(K + 1, np.int64)
        track_cover_ptr[1:] = np.cumsum(np.bincount(pair[:, 0], minlength=K))
        track_cover_unit = pair[:, 1].astype(np.int32)

        arrays = {
            "unit_keys": np.asarray(self._keys, np.int32).reshape(U, 3),
            "unit_seg_ptr": unit_seg_ptr,
            "seg_fid": seg_fid,
            "seg_cell": seg_cell,
            "seg_track": seg_track,
            "track_t_min": track_t_min,
            "track_t_max": track_t_max,
            "track_bbox": track_bbox,
            "track_n_nodes": track_n_nodes,
            "track_type_hist": track_type_hist,
            "track_cover_ptr": track_cover_ptr,
            "track_cover_unit": track_cover_unit,
        }
        return {
            "version": TRACK_INDEX_VERSION,
            "n_tracks": K,
            "n_segments": int(len(seg_fid)),
            "spiral_tol": self.spiral_tol,
            "grid_units": [int(nwi), int(nti), int(ntj)],
            "arrays": {k: encode.pack_ndarray(v) for k, v in arrays.items()},
        }


class TrackIndex:
    """Parsed sidecar index (the read side)."""

    def __init__(self, section: dict):
        v = section.get("version", 0)
        if v > TRACK_INDEX_VERSION:
            raise ValueError(
                f"track index version {v} is newer than this reader "
                f"(supports <= {TRACK_INDEX_VERSION})")
        self.version = v
        self.n_tracks = int(section["n_tracks"])
        self.n_segments = int(section["n_segments"])
        self.spiral_tol = float(section["spiral_tol"])
        self.grid_units = tuple(int(x) for x in section["grid_units"])
        for name in _ARRAY_FIELDS:
            setattr(self, name, encode.unpack_ndarray(
                section["arrays"][name]))
        # once at parse time: per-track summaries must not rescan the
        # segment array per track
        self.track_seg_counts = np.bincount(
            self.seg_track, minlength=self.n_tracks)

    def cover_units(self, track_id: int):
        """Sorted encoded unit keys covering a track."""
        self._check(track_id)
        lo = int(self.track_cover_ptr[track_id])
        hi = int(self.track_cover_ptr[track_id + 1])
        return self.track_cover_unit[lo:hi]

    def track_segments(self, track_id: int):
        """(S, 2) face-id pairs + (S, 3) cells of one track's segments."""
        self._check(track_id)
        sel = self.seg_track == track_id
        return self.seg_fid[sel], self.seg_cell[sel]

    def _check(self, track_id: int):
        if not 0 <= track_id < self.n_tracks:
            raise IndexError(
                f"track id {track_id} out of range [0, {self.n_tracks})")

    def decode_keys(self, enc):
        """Encoded unit keys -> (wi, ti, tj) int arrays."""
        _, nti, ntj = self.grid_units
        enc = np.asarray(enc, np.int64)
        return enc // (nti * ntj), (enc // ntj) % nti, enc % ntj


def parse_track_index(header: dict) -> TrackIndex:
    """TrackIndex of a tiled container's footer header."""
    section = header.get(encode.TRACK_INDEX_KEY)
    if section is None:
        raise ValueError(
            "container has no track index (compressed with "
            "track_index=False or by a pre-index writer); re-compress "
            "with CompressionConfig(track_index=True) to enable "
            "feature-directed queries")
    return TrackIndex(section)
