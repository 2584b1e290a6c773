"""Trajectory analytics of the port: the write side of the CPTT1 track
index (the JAX package's ``repro.analysis``, in part).

* ``extraction.node_positions`` / ``dense_track_ids`` -- crossing nodes
  and canonical track ids;
* ``classify.classify_nodes`` -- critical-point types from the
  interpolated Jacobian;
* ``index.TrackIndexBuilder`` -- the per-unit segment records and the
  footer section a tiled container carries;
* ``query.ContainerSource`` / ``fetch_decoded_units`` -- range reads of
  a container (bytes or a path) for region decodes.

All host numpy float64, copied op for op from the JAX package, so the
index bytes are equal.  The index's read side (track queries, the
decoded-unit cache) is not ported (ROADMAP Queue 1 item 9).
"""
from .classify import classify_nodes  # noqa: F401
from .index import TRACK_INDEX_VERSION, TrackIndexBuilder  # noqa: F401
from .model import CP_CODE, CP_TYPES  # noqa: F401
from .query import ContainerSource  # noqa: F401
