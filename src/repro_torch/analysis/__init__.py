"""Trajectory analytics of the port (the JAX package's
``repro.analysis``): turns the preserved critical-point trajectories
into queryable objects.

* ``extract``             -- full geometric extraction: space-time
                             polylines + CP types (TrajectorySet)
* ``classify_nodes``      -- Jacobian-eigenvalue CP classification
* ``query_tracks``        -- filter the CPTT1 sidecar track index
                             (bbox / time range / CP type); footer only
* ``track_read_plan``     -- directory entries one track needs
* ``decode_for_track``    -- decode ONLY the covering units and rebuild
                             the exact polyline
* ``track_summaries``     -- all per-track index summaries
* ``track_aware_policy``  -- tighten-near-trajectories adaptive eb
                             policy (core.ebpolicy)
* ``ContainerSource`` / ``UnitCache`` -- range reads with retries and
                             the decoded-unit cache of the read path

Positions, types and the index are host numpy float64, op for op the
reference's, so the index bytes and the polylines are equal; the face
predicates, the component labeling and the unit decodes run on the
CUDA device unless ``device="cpu"`` is passed.
"""
from .adaptive import track_aware_policy, track_units  # noqa: F401
from .classify import classify_nodes  # noqa: F401
from .extraction import extract  # noqa: F401
from .index import (  # noqa: F401
    TRACK_INDEX_VERSION,
    TrackIndex,
    TrackIndexBuilder,
    parse_track_index,
)
from .model import CP_CODE, CP_TYPES, Track, TrajectorySet  # noqa: F401
from .query import (  # noqa: F401
    ContainerSource,
    TrackDecode,
    UnitCache,
    configure_unit_cache,
    decode_for_track,
    load_track_index,
    query_tracks,
    track_read_plan,
    track_summaries,
    unit_cache,
)
