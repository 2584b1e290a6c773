"""Tiled and streaming compression with halo-exact trajectory
preservation (the JAX package's ``core/tiling.py``).

The field is split into spatial tiles x temporal windows; every (tile,
window) is an independent unit of a random-access CPTT1 container
(encode.TiledWriter), and the decoded output is BIT-IDENTICAL to the
monolithic pipeline's:

1.  *Order isomorphism.*  The SoS predicate reads vertex ids only
    through ``<``, and a sub-box's local row-major ids keep the global
    order (grid.box_vertex_ids), so predicates and Alg.-2 bounds on a
    halo-extended tile equal the global ones restricted to it.
2.  *Halo-exact eb reduction.*  Each tile derives per-vertex bounds on
    its one-cell / one-frame halo extension; the global bound is the
    MIN over every tile that sees a vertex.
3.  *Pointwise X.*  Dual quantization is pointwise and the residual
    decode an exact inverse, so X -- and the float32 output -- is fixed
    by (eb, forced mask, xi_unit) however residuals are blocked into
    units: units restart the temporal predictor at their first frame
    and run the SL predictor on their own planes.
4.  *Seam-agreed verify.*  The verify loop runs per tile on its
    extension; every face is checked by every tile that sees it with
    equal values and order-isomorphic ids, so the per-round union of
    forced vertices equals the monolithic round's forced set.

Every verify round and the final encode run the units of one batching
signature (``pipeline.unit_signature``) in chunks of at most
``batch_cap``: a chunk of several units goes through the unit-batched
kernel entries, one launch per stage for the chunk (K1, K4, K3 when a
unit has SL blocks, K2); a single unit (and every unit with
``batch_units=False``) through the whole-field entries.  Neither
changes a byte.  The planes stay host numpy, one (H, W) array a frame;
each round uploads each chunk's stacked extension boxes once.

The chunks, the window's eb-derivation groups and its track-index
groups are dealt whole to the cards of the tiles mesh
(``parallel/sharding.py``: ``tiles_devices``, ``map_cards``), each card
with a plan executor of its own; workers read the state and return host
data, and every state write happens on the caller, in work order.  The
bytes do not depend on the number of cards; with one, everything runs
on the caller's thread.

Entry points:

    blob, stats = compress_tiled(u, v, cfg, TileGrid(...))
    blob, stats = compress_stream(frame_pairs, cfg, grid,
                                  value_range=(lo, hi))   # bounded memory
    u, v = decompress_tiled(blob)                          # full field
    u, v = decompress_region(blob, (t0, t1, i0, i1, j0, j1))
    u, v, report = decompress_tiled(blob, degraded=True)   # damaged units
    plan = read_plan(blob, region)   # directory entries a decode reads

Each runs on the CUDA device unless ``device="cpu"`` is passed.  The
compress entries ignore ``cfg.fused`` (and ``REPRO_FUSED``), as the JAX
package's do: every unit runs the fused stages.  The decode entries take
the JAX package's ``backend=``, the SL stepper that replaces the
footer's ``sl_backend``.

``compress_stream`` consumes per-frame ``(u_t, v_t)`` planes and keeps
only the frames the first pending window needs (``_Planes.drop_below``);
a window's units are written once later frames can no longer change its
verify outcome (core/stream_engine.py runs the schedule, serially or on
three overlapped stages).  A verify cascade that would force a vertex
of an already-written window raises StreamingCascadeError.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import time
from typing import Optional

import numpy as np
import torch

from .. import obs
from . import backend, compressor, ebound, ebpolicy, encode, entropy, \
    fixedpoint, pipeline, trajectory
from . import grid as mesh
from ..parallel import sharding

# v4: prologue frame + per-frame preambles + per-unit CRC; v5: device
# codec (CPTH1 unit frames); v6: adaptive eb policy (the header records
# the policy, every unit frame its own base bound)
TILED_FORMAT_VERSION = 4
TILED_FORMAT_VERSION_DEVICE = 5
TILED_FORMAT_VERSION_ADAPTIVE = 6
_EB_BIG = np.int64(2**62)


class StreamingCascadeError(RuntimeError):
    """A verify-and-correct cascade crossed the emitted-window frontier."""


# ----------------------------------------------------------------------
# tile planning
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TileGrid:
    """Tiling geometry: spatial tiles x temporal windows + halo widths."""

    tile_h: int = 128
    tile_w: int = 128
    window_t: int = 32
    halo: int = 1       # spatial halo (cells); >= 1 for halo-exact eb
    thalo: int = 1      # temporal halo (frames); >= 1

    def validate(self):
        if self.tile_h < 1 or self.tile_w < 1 or self.window_t < 1:
            raise ValueError(f"tile/window sizes must be >= 1: {self}")
        if self.halo < 1:
            raise ValueError("spatial halo must cover incident faces "
                             "(halo >= 1)")
        if self.thalo < 1:
            raise ValueError("temporal halo must cover incident slabs "
                             "(thalo >= 1)")


@dataclasses.dataclass(frozen=True)
class TileSpec:
    """One (window, tile) unit: owned + halo-extended half-open boxes."""

    wi: int
    ti: int
    tj: int
    t0: int; t1: int; i0: int; i1: int; j0: int; j1: int
    et0: int; et1: int; ei0: int; ei1: int; ej0: int; ej1: int

    @property
    def key(self):
        return (self.wi, self.ti, self.tj)

    @property
    def owned_box(self):
        return (self.t0, self.t1, self.i0, self.i1, self.j0, self.j1)

    @property
    def ext_box(self):
        return (self.et0, self.et1, self.ei0, self.ei1, self.ej0, self.ej1)

    @property
    def owned_shape(self):
        return (self.t1 - self.t0, self.i1 - self.i0, self.j1 - self.j0)

    @property
    def ext_shape(self):
        return (self.et1 - self.et0, self.ei1 - self.ei0,
                self.ej1 - self.ej0)

    @property
    def owned(self):
        """(ot, oi, oj, To, Ho, Wo): the owned box inside the extension."""
        return (self.t0 - self.et0, self.i0 - self.ei0, self.j0 - self.ej0,
                *self.owned_shape)

    @property
    def owned_in_ext(self):
        return pipeline.owned_slices(self.owned)


def window_specs(wi: int, t0: int, t1: int, H: int, W: int, et1: int,
                 grid: TileGrid):
    """Tile specs of one temporal window (et1 = clamped extended end)."""
    et0 = max(t0 - grid.thalo, 0)
    specs = []
    for ti in range(-(-H // grid.tile_h)):
        i0 = ti * grid.tile_h
        i1 = min(i0 + grid.tile_h, H)
        ei0 = max(i0 - grid.halo, 0)
        ei1 = min(i1 + grid.halo, H)
        for tj in range(-(-W // grid.tile_w)):
            j0 = tj * grid.tile_w
            j1 = min(j0 + grid.tile_w, W)
            ej0 = max(j0 - grid.halo, 0)
            ej1 = min(j1 + grid.halo, W)
            specs.append(TileSpec(wi, ti, tj, t0, t1, i0, i1, j0, j1,
                                  et0, et1, ei0, ei1, ej0, ej1))
    return specs


def plan(shape, grid: TileGrid):
    """All TileSpecs for a full (T, H, W) field."""
    grid.validate()
    T, H, W = shape
    specs = []
    for wi in range(-(-T // grid.window_t)):
        t0 = wi * grid.window_t
        t1 = min(t0 + grid.window_t, T)
        specs.extend(window_specs(wi, t0, t1, H, W,
                                  min(t1 + grid.thalo, T), grid))
    return specs


def _sig(spec: TileSpec):
    return pipeline.unit_signature(spec.ext_shape, spec.owned_shape,
                                   spec.owned[:3])


# ----------------------------------------------------------------------
# per-frame plane storage
# ----------------------------------------------------------------------

class _Planes:
    """Dict-of-frames (H, W) numpy storage with box accessors."""

    def __init__(self, H, W, dtype, fill):
        self.H, self.W = H, W
        self.dtype = dtype
        self.fill = fill
        self.p = {}

    def ensure(self, t):
        if t not in self.p:
            self.p[t] = np.full((self.H, self.W), self.fill, self.dtype)
        return self.p[t]

    def put(self, t, arr):
        self.p[t] = np.asarray(arr, self.dtype)

    def box(self, b):
        t0, t1, i0, i1, j0, j1 = b
        return np.stack([self.ensure(t)[i0:i1, j0:j1]
                         for t in range(t0, t1)])

    def min_box(self, b, vals):
        t0, t1, i0, i1, j0, j1 = b
        for k, t in enumerate(range(t0, t1)):
            sl = self.ensure(t)[i0:i1, j0:j1]
            np.minimum(sl, vals[k], out=sl)

    def or_box(self, b, vals):
        t0, t1, i0, i1, j0, j1 = b
        for k, t in enumerate(range(t0, t1)):
            self.ensure(t)[i0:i1, j0:j1] |= vals[k]

    def drop_below(self, t):
        for k in [k for k in self.p if k < t]:
            del self.p[k]


class _PlanesView:
    """(T, H, W) fancy-indexing facade over _Planes frames (what
    extraction.node_positions and classify gather from)."""

    def __init__(self, planes: _Planes, T: int):
        self.planes = planes
        self.shape = (T, planes.H, planes.W)

    def __getitem__(self, idx):
        t, i, j = np.broadcast_arrays(*(np.asarray(x) for x in idx))
        out = np.empty(t.shape, dtype=self.planes.dtype)
        for tt in np.unique(t):
            m = t == tt
            out[m] = self.planes.p[int(tt)][i[m], j[m]]
        return out


# ----------------------------------------------------------------------
# shared state
# ----------------------------------------------------------------------

@dataclasses.dataclass
class _State:
    cfg: object
    grid: TileGrid
    ex: object                      # pipeline.PlanExecutor
    # the tiles mesh (sharding.tiles_devices; a card may be listed twice)
    # and the plan bound to each of its cards
    cards: list
    exs: dict
    H: int
    W: int
    scale: float
    eb_abs: float
    tau: int
    xi_unit: int
    u: _Planes
    v: _Planes
    ufp: _Planes
    vfp: _Planes
    eb: _Planes
    forced: _Planes
    preds: dict = dataclasses.field(default_factory=dict)
    # the extension's forced mask each unit last checked against (a
    # later fixpoint call re-checks only what was forced since)
    seen: dict = dataclasses.field(default_factory=dict)
    writer: object = None
    tindex: object = None           # analysis.index.TrackIndexBuilder
    n_frames: int = 0
    bad_counts: list = dataclasses.field(default_factory=list)
    rounds: int = 0
    n_ll: int = 0
    n_sl_blocks: int = 0
    n_blocks: int = 0
    n_verts: int = 0
    n_units: int = 0
    batch_cap: int = 8
    policy: object = None           # normalized TilePolicy | None
    ebf: object = None              # adaptive: f64 planes of the bounds
    eb_factor: float = 1.0
    # unit chunks run, by stage and kind: "multi" (unit-batched entries),
    # "single" (whole-field entries), "sl_*" (verify chunks with SL
    # blocks, the ones that decode through K3); "units": by stage, the
    # units each worker of the tiles mesh ran
    chunks: dict = dataclasses.field(default_factory=lambda: {
        "verify": {"multi": 0, "single": 0, "sl_multi": 0, "sl_single": 0},
        "emit": {"multi": 0, "single": 0}})

    @property
    def device(self):
        return self.ex.device


def _init_state(cfg, grid: TileGrid, H, W, vrange, sink, device):
    """Global stream parameters from the exact global value range, bit
    for bit the monolithic derivation (eb_abs, scale, tau, xi_unit)."""
    grid.validate()
    lo, hi = float(vrange[0]), float(vrange[1])
    pol = ebpolicy.normalize(cfg.eb_policy)
    if cfg.mode == "abs":
        eb_factor = 1.0
    else:
        # the range is reduced in float32, as the monolithic path does
        rng = float(np.float32(hi) - np.float32(lo))
        ebpolicy.check_relative_range(rng, max(abs(lo), abs(hi)))
        eb_factor = max(rng, 1e-30)
    eb_abs = float(cfg.eb if pol is None
                   else ebpolicy.max_bound(pol)) * eb_factor
    scale = fixedpoint.compute_scale(max(abs(lo), abs(hi), 1e-300),
                                     cfg.fixed_bits)
    p = pipeline.plan_from_cfg(cfg, scale, eb_abs, name="tiled")
    ex = pipeline.PlanExecutor(p, device)
    cards = sharding.tiles_devices(device)
    all_ll = p.tau < 1 or p.n_usable < 1
    tindex = None
    if cfg.track_index:
        from ..analysis.index import TrackIndexBuilder

        tindex = TrackIndexBuilder(grid, device)
    st = _State(
        cfg=cfg, grid=grid, ex=ex, cards=cards,
        exs={c: pipeline.PlanExecutor(p, c) for c in cards}, H=H, W=W,
        scale=p.scale,
        eb_abs=p.eb_abs, tau=p.tau, xi_unit=p.xi_unit, tindex=tindex,
        batch_cap=max(int(cfg.batch_cap), 1),
        u=_Planes(H, W, np.float32, 0.0),
        v=_Planes(H, W, np.float32, 0.0),
        ufp=_Planes(H, W, np.int64, 0),
        vfp=_Planes(H, W, np.int64, 0),
        eb=_Planes(H, W, np.int64, _EB_BIG),
        forced=_Planes(H, W, bool, all_ll),
        policy=pol,
        ebf=None if pol is None else _Planes(H, W, np.float64, np.inf),
        eb_factor=eb_factor,
    )
    st.chunks["units"] = {stage: [0] * len(cards)
                          for stage in ("derive", "verify", "emit", "index")}
    # the prologue frame repeats the global decode parameters up front
    # (shape[0] is 0: the length is known only at the end)
    prologue = _container_header(st, 0)
    prologue["prologue"] = True
    st.writer = encode.TiledWriter(sink, cfg.zstd_level, prologue=prologue)
    return st


def _add_frame(st: _State, t, u_t, v_t, ufp_t=None, vfp_t=None):
    """Insert frame ``t``; ``ufp_t`` / ``vfp_t`` take fixed-point planes
    computed off-thread (the async engine's ingest stage: the rounding
    is deterministic, so where it runs changes no bit)."""
    u_t = np.asarray(u_t, np.float32)
    v_t = np.asarray(v_t, np.float32)
    if u_t.shape != (st.H, st.W) or v_t.shape != (st.H, st.W):
        raise ValueError(
            f"frame {t} shape {u_t.shape}/{v_t.shape} != ({st.H}, {st.W})")
    st.n_frames = max(st.n_frames, t + 1)
    st.u.put(t, u_t)
    st.v.put(t, v_t)
    if ufp_t is None:
        ufp_t = np.round(u_t.astype(np.float64) * st.scale)
    if vfp_t is None:
        vfp_t = np.round(v_t.astype(np.float64) * st.scale)
    st.ufp.put(t, ufp_t)
    st.vfp.put(t, vfp_t)


def _stack(specs, planes: _Planes, card, box="ext_box"):
    """The specs' boxes of ``planes`` stacked, as one tensor on ``card``
    (one upload)."""
    return torch.as_tensor(np.stack([planes.box(getattr(s, box))
                                     for s in specs]), device=card)


def _map(st: _State, stage: str, fn, items, weight=len):
    """``fn(st, items_of_card, card)`` over the tiles mesh; the results in
    item order.  Tallies the units each worker ran under ``stage``."""
    out, slots = sharding.map_cards(functools.partial(fn, st), items,
                                    st.cards, weight)
    for it, k in zip(items, slots):
        st.chunks["units"][stage][k] += weight(it)
    return out


def _derive_groups(st: _State, groups, card):
    """Per extension-shape group on ``card``: the units' eb planes (host)
    and original face predicates (on the host when the mesh has several
    workers: a verify chunk may run on another card)."""
    out = []
    for specs in groups:
        ebs, slice_c, slab_c = ebound.derive_vertex_eb_units(
            _stack(specs, st.ufp, card), _stack(specs, st.vfp, card),
            int(max(st.tau, 1)))
        if len(st.cards) > 1:
            slice_c, slab_c = slice_c.cpu(), slab_c.cpu()
        out.append((ebs.cpu().numpy(), slice_c, slab_c))
    return out


def _derive_window(st: _State, w):
    """Per-tile eb + original face predicates of one window, min-reduced
    into the global per-vertex bound planes."""
    groups = {}
    for spec in w.specs:
        groups.setdefault(spec.ext_shape, []).append(spec)
    groups = list(groups.values())
    with obs.span("tiling.derive_window", window=int(w.wi),
                  units=len(w.specs)):
        rows = {}
        for specs, (ebs, slice_c, slab_c) in zip(
                groups, _map(st, "derive", _derive_groups, groups)):
            for k, spec in enumerate(specs):
                rows[spec.key] = (ebs[k], slice_c[k], slab_c[k])
        for spec in w.specs:
            ebs, slice_c, slab_c = rows[spec.key]
            st.eb.min_box(spec.ext_box, ebs)
            st.preds[spec.key] = (slice_c, slab_c)
    if st.policy is not None:
        # the adaptive policy's per-vertex caps (and f64 bounds for the
        # verify check and the eb_base headers), min-reduced: idempotent
        for t in range(min(s.et0 for s in w.specs), w.et1):
            boundf = ebpolicy.frame_bounds(st.policy, t, st.H, st.W,
                                           st.eb_factor)
            cap = np.floor(boundf * st.scale).astype(np.int64)
            np.minimum(st.eb.ensure(t), cap, out=st.eb.ensure(t))
            np.minimum(st.ebf.ensure(t), boundf, out=st.ebf.ensure(t))


# ----------------------------------------------------------------------
# unit chunks: encode + one verify round
# ----------------------------------------------------------------------

def _encode_chunk(st: _State, specs, ufp, vfp, card):
    """Encode a chunk of same-signature units from their (B, Te, He, We)
    boxes uploaded to ``card``.  Returns (xu_e, xv_e, ll_e, res_u, res_v,
    bms) with the unit axis first (bms host numpy)."""
    ex = st.exs[card]
    owned = specs[0].owned
    eb = _stack(specs, st.eb, card)
    extra = _stack(specs, st.forced, card)
    if len(specs) > 1:
        return ex.encode_units(owned, ufp, vfp, eb, extra)
    out = ex.encode_unit(ufp[0], vfp[0], eb[0], extra[0], owned)
    return tuple(x[None] for x in out)


def _round_chunk(st: _State, specs, deltas, card):
    """One verify round on a chunk of same-signature units on ``card``,
    all screened (deltas None: first contact) or all incremental
    (deltas: the ext masks of vertices forced since the unit last
    checked).  Returns ([(spec, forced_ext host bool)], n_bad, whether a
    unit has SL blocks): decisions bit-equal to the monolithic round
    restricted to each extension."""
    ex = st.exs[card]
    B = len(specs)
    ufp = _stack(specs, st.ufp, card)
    vfp = _stack(specs, st.vfp, card)
    extra = _stack(specs, st.forced, card)
    xu_e, xv_e, ll_e, res_u, res_v, bms = _encode_chunk(st, specs, ufp, vfp,
                                                        card)
    # simulate the units' exact decode, paste it into the extensions
    if B > 1:
        xu_d, xv_d = ex.decode_units(res_u, res_v, bms)
    else:
        xu_d, xv_d = (x[None] for x in ex.decode_fields(res_u[0], res_v[0],
                                                         bms[0]))
    o = (slice(None),) + specs[0].owned_in_ext
    xu_sim = xu_e.clone()
    xv_sim = xv_e.clone()
    xu_sim[o] = xu_d
    xv_sim[o] = xv_d
    bound = st.eb_abs if st.policy is None else _stack(specs, st.ebf, card)
    forced, n_pt, ur_fp, vr_fp = pipeline._check_pt_core(
        xu_sim, xv_sim, ll_e, extra, _stack(specs, st.u, card),
        _stack(specs, st.v, card), st.scale, st.xi_unit, bound)
    delta = None if deltas[0] is None else torch.as_tensor(
        np.stack(deltas), device=card)
    # no copy where the window's derivation ran on this card
    slice0 = torch.stack([st.preds[s.key][0] for s in specs]).to(card)
    slab0 = torch.stack([st.preds[s.key][1] for s in specs]).to(card)
    tabs = ex.tables(*specs[0].ext_shape[1:])
    if B > 1:
        n_face = backend.verify_faces_units(
            ur_fp, vr_fp, ufp, vfp, delta, tabs["slice"], tabs["slab"],
            slice0, slab0, forced)
    else:
        n_face = backend.verify_faces(
            ur_fp[0], vr_fp[0], ufp[0], vfp[0],
            None if delta is None else delta[0], tabs["slice"],
            tabs["slab"], slice0[0], slab0[0], forced[0])
    n_bad = int(n_pt + n_face)
    forced_np = forced.cpu().numpy()
    return ([(spec, forced_np[b]) for b, spec in enumerate(specs)], n_bad,
            bool(bms[:, 1:].any()))


def _chunks(st: _State, items, key):
    """``items`` grouped by ``key(item)`` in first-seen order, each group
    cut into chunks of at most batch_cap (one chunk an item without
    batch_units)."""
    if not st.ex.plan.batch_units:
        return [[it] for it in items]
    groups = {}
    for it in items:
        groups.setdefault(key(it), []).append(it)
    return [g[lo:lo + st.batch_cap] for g in groups.values()
            for lo in range(0, len(g), st.batch_cap)]


def _round_chunks(st: _State, chunks, card):
    return [_round_chunk(st, [s for s, _ in chunk], [d for _, d in chunk],
                         card) for chunk in chunks]


def _round_work(st: _State, work):
    """One verify round over ``work`` = [(spec, delta)], its chunks dealt
    whole to the tiles mesh.  Returns ([(spec, forced_ext)], n_bad)."""
    chunks = _chunks(st, work, lambda sd: (_sig(sd[0]), sd[1] is None))
    if st.ex.plan.batch_units:
        for chunk in chunks:
            obs.observe("pipeline.batch_group_size", len(chunk))
    out, n_bad = [], 0
    for chunk, (res, nb, has_sl) in zip(
            chunks, _map(st, "verify", _round_chunks, chunks)):
        kind = "multi" if len(chunk) > 1 else "single"
        st.chunks["verify"][kind] += 1
        st.chunks["verify"]["sl_" + kind] += has_sl
        out.extend(res)
        n_bad += nb
    return out, n_bad


def _fixpoint(st: _State, windows, frontier: int = 0):
    """The seam-agreed verify loop over the windows' units: per round
    every participating unit checks its extension as the monolithic
    round would (screen on first contact, the faces of newly forced
    vertices after it), and the round's union of forced vertices is
    applied globally before the next round.  A unit checked by an
    earlier call joins only with the vertices forced since (``seen``).
    Raises StreamingCascadeError when an addition lands below
    ``frontier`` (an already-written frame)."""
    cfg = st.cfg
    specs = [s for w in windows for s in w.specs]
    work = []
    for spec in specs:
        if spec.key not in st.seen:
            work.append((spec, None))
        else:
            delta = st.forced.box(spec.ext_box) & ~st.seen[spec.key]
            if delta.any():
                work.append((spec, delta))
    rounds = 0
    while work:
        additions = {}
        with obs.span("tiling.verify_round", round=rounds, units=len(work)):
            round_out, n_bad = _round_work(st, work)
        for spec, forced_ext in round_out:
            new = forced_ext & ~st.forced.box(spec.ext_box)
            for k in range(new.shape[0]):
                if new[k].any():
                    acc = additions.setdefault(
                        spec.et0 + k, np.zeros((st.H, st.W), bool))
                    acc[spec.ei0:spec.ei1, spec.ej0:spec.ej1] |= new[k]
        st.bad_counts.append(n_bad)
        if not additions or rounds >= cfg.max_rounds:
            break
        if min(additions) < frontier:
            raise StreamingCascadeError(
                f"verify cascade reached emitted frame {min(additions)} "
                f"(< frontier {frontier}); increase window_t or use "
                f"compress_tiled")
        for t, mask in additions.items():
            st.forced.ensure(t)
            st.forced.p[t] |= mask
        rounds += 1
        st.rounds = max(st.rounds, rounds)
        work = []
        for spec in specs:
            t0, t1, i0, i1, j0, j1 = spec.ext_box
            delta = np.stack([
                additions[t][i0:i1, j0:j1] if t in additions
                else np.zeros((i1 - i0, j1 - j0), bool)
                for t in range(t0, t1)])
            if delta.any():
                work.append((spec, delta))
    obs.count("tiling.verify_rounds", rounds)
    for spec in specs:
        st.seen[spec.key] = st.forced.box(spec.ext_box)


# ----------------------------------------------------------------------
# per-unit trajectory segments (the track index)
# ----------------------------------------------------------------------
#
# A unit owns the tets anchored in its owned box (slabs [t0, min(t1,
# T-1)), cells [i0, min(i1, H-1)) x [j0, min(j1, W-1)) -- a partition of
# all tets).  Their faces' crossed state is evaluated on the halo
# extension with ids local to it (order-isomorphic to the global ids),
# one K2 ``face_crossed`` launch per geometry group, the units' ids
# offset by a constant each (which keeps every face's SoS order); the
# host pass turns crossings into global face ids, anchor cells and
# crossing nodes for the TrackIndexBuilder.


def _local_tet_faces(key, device):
    """(n_slabs * Ntl * 4, 3) int64 tensor of the tet-face vertex ids,
    local to the extension box, of the tets a unit owns, in the grid.py
    order (tau1|tau2|tau3 over tri1|tri2 over row-major cells); None
    when it owns none.  Built on the device for each group (a few
    elementwise ops): at 128 x 128 x 32 tiles a table is 0.3 GB, too much
    to keep."""
    Te, he, we, dt0, di0, dj0, nsl, nci, ncj = key
    if nsl <= 0 or nci <= 0 or ncj <= 0:
        return None
    dev = torch.device(device)
    P = he * we
    ii, jj = torch.meshgrid(torch.arange(nci, device=dev),
                            torch.arange(ncj, device=dev), indexing="ij")

    def sid(i, j):
        return ((di0 + i) * we + (dj0 + j)).reshape(-1).to(torch.int64)

    v00, v10 = sid(ii, jj), sid(ii, jj + 1)
    v01, v11 = sid(ii + 1, jj), sid(ii + 1, jj + 1)
    tris = torch.cat([torch.stack([v00, v01, v11], 1),
                      torch.stack([v00, v10, v11], 1)])
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    tets = torch.cat([torch.stack([a, b, c, c + P], 1),
                      torch.stack([a, b, b + P, c + P], 1),
                      torch.stack([a, a + P, b + P, c + P], 1)])
    faces = tets[:, torch.as_tensor(mesh.TET_FACES, device=dev).long()]
    out = faces[None] + ((dt0 + torch.arange(nsl, device=dev)) * P)[
        :, None, None, None]
    return out.reshape(-1, 3).contiguous()


def _crossed_rows(spec: TileSpec, crossed, key):
    """The device half of a unit's segment records: ``crossed`` is its
    (n_slabs * Ntl * 4,) bool tensor; only the tets with two crossed
    faces reach the host, as (tet index j, their 4 flags), or None."""
    nsl, nci, ncj = key[6:]
    Ntl = 6 * nci * ncj
    crossed = crossed.reshape(nsl * Ntl, 4)
    n_crossed = crossed.sum(dim=1)
    if bool(((n_crossed != 0) & (n_crossed != 2)).any()):
        trajectory.check_lemma1(crossed.reshape(nsl, Ntl, 4).cpu().numpy(),
                                t_lo=spec.t0)
    j = torch.nonzero(n_crossed == 2).reshape(-1)
    if len(j) == 0:
        return None
    return j.cpu().numpy(), crossed[j].cpu().numpy()


def _unit_segment_records(st: _State, spec: TileSpec, crossed_rows, key):
    """A unit's local crossings (``_crossed_rows``) -> global segments
    (face id pairs, anchor cells) + crossing nodes (face id, position,
    CP type), on the host."""
    from ..analysis import classify as classify_mod
    from ..analysis import extraction

    if crossed_rows is None:
        return _empty_records()
    j, rows = crossed_rows
    nsl, nci, ncj = key[6:]
    H, W = st.H, st.W
    ncc = nci * ncj
    Ntl = 6 * ncc
    _, slots = np.nonzero(rows)
    slots = slots.reshape(-1, 2)
    rt = j // Ntl
    r = j % Ntl
    k = r // (2 * ncc)
    rq = r % (2 * ncc)
    q = rq // ncc
    cc = rq % ncc
    gi = spec.i0 + cc // ncj
    gj = spec.j0 + cc % ncj
    ts = spec.t0 + rt
    gtet = (k * 2 + q) * ((H - 1) * (W - 1)) + gi * (W - 1) + gj
    family, index = mesh.tet_face_map(H, W)
    seg_fid = mesh.tet_face_fids(
        family[gtet[:, None], slots], index[gtet[:, None], slots],
        ts[:, None], H, W)
    seg_cell = np.stack([ts, gi, gj], axis=1).astype(np.int32)

    node_fid = np.unique(seg_fid)
    uview = _PlanesView(st.ufp, st.n_frames)
    vview = _PlanesView(st.vfp, st.n_frames)
    node_pos = extraction.node_positions(node_fid, uview, vview, uview.shape)
    node_type = classify_mod.classify_nodes(
        uview, vview, node_pos, spiral_tol=st.tindex.spiral_tol)
    return seg_fid, seg_cell, node_fid, node_pos, node_type


def _empty_records():
    e = np.empty
    return (e((0, 2), np.int64), e((0, 3), np.int32), e(0, np.int64),
            e((0, 3), np.float64), e(0, np.int8))


def _segment_groups(st: _State, groups, card):
    """Per geometry group (key, specs) on ``card``: one predicate launch,
    then each unit's ``_crossed_rows``."""
    out = []
    for key, specs in groups:
        faces = _local_tet_faces(key, card)
        if faces is None:
            out.append([None] * len(specs))
            continue
        B = len(specs)
        n_ext = int(np.prod(specs[0].ext_shape))
        verts = (faces[None] + (torch.arange(B, device=card)
                                * n_ext)[:, None, None]).reshape(-1, 3)
        crossed = backend.face_crossed(
            _stack(specs, st.ufp, card).reshape(-1),
            _stack(specs, st.vfp, card).reshape(-1), verts).reshape(B, -1)
        out.append([_crossed_rows(spec, crossed[b], key)
                    for b, spec in enumerate(specs)])
    return out


def _window_segment_records(st: _State, w) -> dict:
    """Segment records of one window's units, one predicate launch per
    extension-geometry group; the groups go over the tiles mesh, the
    host conversion runs here."""
    T = st.n_frames
    groups = {}
    for spec in w.specs:
        key = (spec.ext_shape + spec.owned[:3] + (
            min(spec.t1, T - 1) - spec.t0,
            min(spec.i1, st.H - 1) - spec.i0,
            min(spec.j1, st.W - 1) - spec.j0))
        groups.setdefault(key, []).append(spec)
    groups = list(groups.items())
    records = {}
    for (key, specs), rows in zip(groups, _map(
            st, "index", _segment_groups, groups, lambda g: len(g[1]))):
        for spec, r in zip(specs, rows):
            records[spec.key] = _unit_segment_records(st, spec, r, key)
    return records


# ----------------------------------------------------------------------
# unit emission
# ----------------------------------------------------------------------

@dataclasses.dataclass
class _UnitPayload:
    """What the write stage needs for one unit: host data only, with no
    reference into the plane store (the async engine hands payloads to
    its writer thread, which launches nothing and copies nothing from
    the device)."""

    key: tuple
    box: tuple
    ll: object          # owned lossless mask (np bool)
    u_ll: object        # raw values at lossless vertices (np f32)
    v_ll: object
    res_u: object       # residual streams (host numpy, host codec)
    res_v: object
    bm: object          # blockmap (np bool)
    seg: object         # segment records | None
    frag: object = None  # device-codec entropy fragment (res_* released)
    eb_base: object = None  # adaptive: the unit's loosest absolute bound


def _emit_chunks(st: _State, chunks, card):
    """The final-mask encode of unit chunks on ``card``: per chunk, its
    units' payloads with the host data of this stage only (the lossless
    mask, the residual streams -- coded here, on the card, with the
    device codec -- and the blockmap)."""
    ex = st.exs[card]
    out = []
    for chunk in chunks:
        ufp = _stack(chunk, st.ufp, card)
        vfp = _stack(chunk, st.vfp, card)
        _, _, ll_e, res_u, res_v, bms = _encode_chunk(st, chunk, ufp, vfp,
                                                      card)
        o = (slice(None),) + chunk[0].owned_in_ext
        ll_o = ll_e[o].cpu().numpy()
        if ex.codec != "device":
            res_u, res_v = res_u.cpu().numpy(), res_v.cpu().numpy()
        out.append([_UnitPayload(key=spec.key, box=spec.owned_box,
                                 ll=ll_o[b], u_ll=None, v_ll=None,
                                 res_u=res_u[b], res_v=res_v[b], bm=bms[b],
                                 seg=None)
                    for b, spec in enumerate(chunk)])
    if ex.codec == "device":
        _attach_entropy_fragments(ex, [p for ps in out for p in ps])
    return out


def _unit_payloads(st: _State, w):
    """The final-mask encode of one window's units (chunked by
    signature as the verify rounds are, the chunks dealt to the tiles
    mesh) and their payloads, in the window's spec order (the order the
    writer emits)."""
    with obs.span("tiling.unit_payloads", window=int(w.wi),
                  units=len(w.specs)):
        seg_records = _window_segment_records(st, w) \
            if st.tindex is not None else None
        chunks = _chunks(st, w.specs, _sig)
        encoded = {}
        for chunk, ps in zip(chunks, _map(st, "emit", _emit_chunks, chunks)):
            st.chunks["emit"]["multi" if len(chunk) > 1 else "single"] += 1
            encoded.update((p.key, p) for p in ps)
        payloads = []
        for spec in w.specs:
            p = encoded.pop(spec.key)
            p.u_ll = st.u.box(spec.owned_box)[p.ll]
            p.v_ll = st.v.box(spec.owned_box)[p.ll]
            p.seg = None if seg_records is None else seg_records[spec.key]
            if st.policy is not None:
                p.eb_base = float(st.ebf.box(spec.owned_box).max())
            payloads.append(p)
            # its original predicates and seam snapshot are dead now
            st.preds.pop(spec.key, None)
            st.seen.pop(spec.key, None)
    return payloads


def _attach_entropy_fragments(ex, payloads):
    """Device entropy coding of payloads on one card, stacked by owned
    shape (one batched pass a shape; per-unit tables keep the bytes
    independent of the grouping, so of the cards' shares)."""
    groups = {}
    for i, p in enumerate(payloads):
        groups.setdefault(tuple(p.res_u.shape), []).append(i)
    with obs.span("tiling.entropy_fragments", units=len(payloads),
                  groups=len(groups)):
        for idxs in groups.values():
            obs.observe("pipeline.batch_group_size", len(idxs))
            frags = ex.entropy_fragments(
                torch.stack([payloads[i].res_u for i in idxs]),
                torch.stack([payloads[i].res_v for i in idxs]))
            for i, frag in zip(idxs, frags):
                payloads[i].frag = frag
                payloads[i].res_u = payloads[i].res_v = None


def _write_unit(st: _State, p: _UnitPayload):
    """Symbolize + pack one unit, record its directory and index rows
    (host work on the payload only: the async engine's writer thread
    runs it)."""
    header = {"box": [int(x) for x in p.box]}
    if p.eb_base is not None:
        header["eb_base"] = float(p.eb_base)
    if p.frag is not None:
        sections = entropy.merge_sections(p.frag, p.ll, p.u_ll, p.v_ll, p.bm)
    else:
        sections = encode.field_sections(p.res_u, p.res_v, p.ll, p.u_ll,
                                         p.v_ll, p.bm)
    st.writer.add_unit(p.key, p.box, header, sections)
    if p.seg is not None:
        st.tindex.add_unit(p.key, *p.seg)
    obs.count("tiling.units_written", 1)
    st.n_units += 1
    st.n_ll += int(p.ll.sum())
    st.n_verts += p.ll.size
    st.n_sl_blocks += int(p.bm.sum())
    st.n_blocks += p.bm.size


def _emit_window(st: _State, w):
    payloads = _unit_payloads(st, w)
    with obs.span("tiling.write_units", window=int(w.wi),
                  units=len(payloads)):
        for p in payloads:
            _write_unit(st, p)


def _finish_header(st: _State, T: int):
    """Container header + the optional track-index footer section (an
    extra key: the container version does not move)."""
    header = _container_header(st, T)
    if st.tindex is not None:
        header[encode.TRACK_INDEX_KEY] = st.tindex.finalize((T, st.H, st.W))
    return header


def _container_header(st: _State, T: int):
    """The JAX package's tiled header with this package's SL stepper tag;
    the key order fixes the bytes."""
    cfg = st.cfg
    if st.policy is not None:
        version = TILED_FORMAT_VERSION_ADAPTIVE
    elif st.ex.codec == "device":
        version = TILED_FORMAT_VERSION_DEVICE
    else:
        version = TILED_FORMAT_VERSION
    header = {
        "version": version,
        "pipeline": "tiled",
        "predictor": cfg.predictor,
        "sl_backend": st.ex.plan.sl_backend,
        "shape": [int(T), int(st.H), int(st.W)],
        "scale": float(st.scale),
        "xi_unit": int(st.xi_unit),
        "block": int(cfg.block),
        "cfl_x": float(cfg.dt / cfg.dx),
        "cfl_y": float(cfg.dt / cfg.dy),
        "d_max": float(cfg.d_max),
        "n_max": int(cfg.n_max),
        "eb_abs": float(st.eb_abs),
        "tiling": dataclasses.asdict(st.grid),
    }
    if st.policy is not None:
        header["eb_policy"] = ebpolicy.policy_spec(st.policy)
    return header


def _stats(st: _State, T, blob, t0):
    """The monolithic stats keys + the tiled ones.  verify_bad_counts sums
    per-tile counts (a seam face counts once per tile that sees it), as
    in the JAX package; the forced sets are the monolithic ones."""
    orig_bytes = T * st.H * st.W * 4 * 2
    comp_bytes = len(blob) if blob is not None else st.writer.bytes_written
    return {
        "orig_bytes": orig_bytes,
        "comp_bytes": comp_bytes,
        "ratio": orig_bytes / max(comp_bytes, 1),
        "lossless_frac": st.n_ll / max(st.n_verts, 1),
        "sl_block_frac": st.n_sl_blocks / max(st.n_blocks, 1),
        "verify_rounds": st.rounds,
        "verify_bad_counts": st.bad_counts,
        "eb_abs": st.eb_abs,
        "scale": st.scale,
        "tau": st.tau,
        "xi_unit": st.xi_unit,
        "seconds": time.perf_counter() - t0,
        "device": str(st.device),
        "pipeline": "tiled",
        "n_units": st.n_units,
        "tiling": dataclasses.asdict(st.grid),
        "batch_units": st.ex.plan.batch_units,
        "chunks": st.chunks,
    }


class _Window:
    def __init__(self, wi, t0, t1, specs):
        self.wi, self.t0, self.t1 = wi, t0, t1
        self.specs = specs
        self.et1 = max(s.et1 for s in specs)


# ----------------------------------------------------------------------
# entry points
# ----------------------------------------------------------------------

def _prepare(u, v, cfg, grid: TileGrid, sink, device):
    """Load an in-memory field into the state and derive every window."""
    u, v = compressor._as_fields(u, v)
    T, H, W = u.shape
    vrange = (float(min(u.min(), v.min())), float(max(u.max(), v.max())))
    st = _init_state(cfg, grid, H, W, vrange, sink, device)
    for t in range(T):
        _add_frame(st, t, u[t], v[t])
    windows = []
    for wi in range(-(-T // grid.window_t)):
        t0 = wi * grid.window_t
        t1 = min(t0 + grid.window_t, T)
        et1 = min(t1 + grid.thalo, T)
        windows.append(_Window(wi, t0, t1,
                               window_specs(wi, t0, t1, H, W, et1, grid)))
    for w in windows:
        _derive_window(st, w)
    return st, windows, T


def compress_tiled(u, v, cfg=None, grid: Optional[TileGrid] = None,
                   sink=None, *, device=None):
    """Tiled compression of an in-memory (T, H, W) field; the decode is
    bit-identical to the monolithic pipeline's.  Returns (blob, stats);
    blob is None when ``sink`` (a binary writer) is given."""
    cfg = cfg or compressor.CompressionConfig()
    compressor.refuse_unported(cfg)
    grid = grid or cfg.tiling or TileGrid()
    if not isinstance(grid, TileGrid):
        raise TypeError(f"tiling must be a TileGrid, got {grid!r}")
    grid.validate()
    dev = compressor.resolve_device(device)
    compressor.refuse_plain_on_card(cfg, dev)
    t_start = time.perf_counter()
    with obs.span("tiling.compress_tiled", codec=None) as sp:
        st, windows, T = _prepare(u, v, cfg, grid, sink, dev)
        sp.set(codec=st.ex.codec, n_windows=len(windows),
               shape=[int(T), int(st.H), int(st.W)])
        if cfg.verify:
            with obs.span("tiling.fixpoint", n_windows=len(windows)):
                _fixpoint(st, windows)
        for w in windows:
            _emit_window(st, w)
        blob = st.writer.finish(_finish_header(st, T))
    return blob, _stats(st, T, blob, t_start)


def compress_stream(pairs, cfg=None, grid: Optional[TileGrid] = None,
                    value_range=None, sink=None, async_engine=False,
                    resume=False, faults=None, stage_timeout=None,
                    autotune=False, n_frames_hint: Optional[int] = None, *,
                    device=None):
    """Streaming tiled compression of an iterable of (u_t, v_t) frames;
    the bytes equal ``compress_tiled``'s for the same field.

    ``value_range=(lo, hi)`` must be the exact global min / max over both
    components (it fixes the fixed-point scale and a relative bound
    before the first frame); without it the stream is materialized and
    compressed by compress_tiled (or, with ``async_engine``, run through
    the engine on the exact range).  Returns (blob, stats); blob is None
    when writing to ``sink`` (a binary writer or a filesystem path).

    ``async_engine=True`` overlaps frame ingestion, the device work (on
    the caller's thread) and the host pack on three stages
    (core/stream_engine.py) with the same bytes.  With a path ``sink``
    the run keeps a write-ahead journal at ``<sink>.journal``;
    ``resume=True`` finishes a crashed run from its last checkpoint,
    byte-identical to an uninterrupted one, reading frames from the
    journal's ``resume_from`` on (``pairs`` may be a callable
    ``pairs(t_start) -> iterable``; an iterable is skipped forward).
    ``faults`` (core/faults.py FaultPlan) and ``stage_timeout`` (seconds,
    or REPRO_STAGE_TIMEOUT) are the engine's fault-injection and
    watchdog hooks.

    ``autotune=True`` picks the grid, codec and scheduling with the cost
    model before any frame is compressed (repro_torch.autotune,
    model-only: a stream cannot be rerun per candidate);
    ``n_frames_hint`` stands in for the stream's length when ``pairs``
    has no ``len``.  It is refused with ``resume``: a resumed run must
    replay the journaled plan, not search for a new one."""
    cfg = cfg or compressor.CompressionConfig()
    compressor.refuse_unported(cfg)
    if autotune:
        if resume:
            raise ValueError(
                "autotune=True cannot be combined with resume=True: a "
                "resumed run must replay the journaled plan exactly; "
                "rerun with the original grid/config")
        from .. import autotune as autotune_mod

        src = pairs(0) if callable(pairs) else pairs
        try:
            n_frames = len(src)
        except TypeError:
            n_frames = None
        it = iter(src)
        try:
            first = next(it)
        except StopIteration:
            raise ValueError("autotune=True needs at least one frame")
        H, W = np.asarray(first[0]).shape
        cfg, cand = autotune_mod.tune_stream(
            (n_frames or n_frames_hint or 64, H, W), cfg, device=device)
        grid = cfg.tiling
        async_engine = cand.async_engine
        pairs = itertools.chain([first], it)
    grid = grid or cfg.tiling or TileGrid()
    if not isinstance(grid, TileGrid):
        raise TypeError(f"tiling must be a TileGrid, got {grid!r}")
    grid.validate()
    dev = compressor.resolve_device(device)
    compressor.refuse_plain_on_card(cfg, dev)
    from . import stream_engine

    if value_range is None:
        if resume:
            raise ValueError(
                "resume=True needs an explicit value_range: the range "
                "fixes the fixed-point scale, and a resumed run must "
                "derive bit-identical parameters without re-reading "
                "already-compressed frames")
        src = pairs(0) if callable(pairs) else pairs
        frames = [(np.asarray(uf, np.float32), np.asarray(vf, np.float32))
                  for uf, vf in src]
        if not async_engine:
            u = np.stack([f[0] for f in frames])
            v = np.stack([f[1] for f in frames])
            return compress_tiled(u, v, cfg, grid, sink=sink, device=dev)
        lo = min(min(float(uf.min()), float(vf.min())) for uf, vf in frames)
        hi = max(max(float(uf.max()), float(vf.max())) for uf, vf in frames)
        pairs = frames
        value_range = (lo, hi)

    return stream_engine.run(pairs, cfg, grid, value_range, sink,
                             async_engine=async_engine, resume=resume,
                             faults=faults, stage_timeout=stage_timeout,
                             device=dev)


# ----------------------------------------------------------------------
# decode: full, region, read planning
# ----------------------------------------------------------------------

def _overlaps(box, region):
    t0, t1, i0, i1, j0, j1 = box
    rt0, rt1, ri0, ri1, rj0, rj1 = region
    return t0 < rt1 and rt0 < t1 and i0 < ri1 and ri0 < i1 \
        and j0 < rj1 and rj0 < j1


def _source_of(src):
    """A ContainerSource over bytes or a path (closed on exit), or the
    caller's own ContainerSource (left open)."""
    from ..analysis import query

    if isinstance(src, query.ContainerSource):
        return contextlib.nullcontext(src)
    return query.ContainerSource(src)


def _plan_entries(hdr: dict, region=None):
    """Directory entries overlapping ``region``: the one coverage rule of
    read planning and region decode."""
    if region is None:
        return list(hdr["units"])
    return [e for e in hdr["units"] if _overlaps(e["box"], region)]


def read_plan(src, region=None):
    """Directory entries a region decode reads, and nothing else.
    ``src``: container bytes, a path or an analysis.query.ContainerSource."""
    with _source_of(src) as source:
        hdr = source.header()
    return _plan_entries(hdr, region)


@dataclasses.dataclass
class DecodeReport:
    """What a degraded decode could and could not recover.

    ``missing_units`` holds one {"key", "box", "error"} dict per unit
    that failed its checksum or could not be read; its voxels are holes
    (0).  ``retries`` is the per-site :func:`faults.retry_stats` snapshot
    when the decode finished, so a decode that succeeded only on retries
    does not look like a clean one."""

    n_units: int = 0                 # units the region plan touched
    n_decoded: int = 0
    missing_units: list = dataclasses.field(default_factory=list)
    retries: dict = dataclasses.field(default_factory=dict)

    @property
    def complete(self) -> bool:
        return not self.missing_units

    def hole_mask(self, region):
        """Bool mask over ``region`` of the voxels lost to missing units
        (True = hole)."""
        rt0, rt1, ri0, ri1, rj0, rj1 = region
        mask = np.zeros((rt1 - rt0, ri1 - ri0, rj1 - rj0), dtype=bool)
        for m in self.missing_units:
            t0, t1, i0, i1, j0, j1 = m["box"]
            mask[max(t0, rt0) - rt0: max(min(t1, rt1) - rt0, 0),
                 max(i0, ri0) - ri0: max(min(i1, ri1) - ri0, 0),
                 max(j0, rj0) - rj0: max(min(j1, rj1) - rj0, 0)] = True
        return mask


def decompress_tiled(src, region=None, backend=None, degraded=False, *,
                     device=None):
    """Decode a tiled container (the whole field, or ``region`` = (t0,
    t1, i0, i1, j0, j1)) from bytes, a path or a ContainerSource: reads
    only the units whose owned boxes overlap the region, one range read
    a unit.  Returns (u, v) float32 numpy arrays of the region.  A
    region decode goes through the decoded-unit cache
    (analysis/query.py); a full decode streams unit by unit past it.

    ``backend`` names the SL stepper of the decode in place of the
    footer's ``sl_backend`` ("numpy", "xla" or "pallas").

    ``degraded=True`` turns per-unit damage (checksum mismatch, short
    read) into a report: the return is ``(u, v, DecodeReport)`` with the
    damaged units' voxels left 0.  A corrupt footer still raises (run
    ``encode.salvage_container`` first)."""
    dev = compressor.resolve_device(device)
    compressor.refuse_plain_on_card(backend, dev)
    from ..analysis import query

    report = DecodeReport()
    with _source_of(src) as source:
        hdr = source.header()
        version = hdr.get("version", 1)
        if not isinstance(version, int) \
                or version > TILED_FORMAT_VERSION_ADAPTIVE:
            raise ValueError(
                f"container format version {version} is newer than this "
                f"decoder (supports <= {TILED_FORMAT_VERSION_ADAPTIVE})")
        try:
            T, H, W = (int(x) for x in hdr["shape"])
        except (KeyError, TypeError, ValueError) as e:
            raise encode.ContainerError(
                f"malformed container shape: {e}") from e
        if region is None:
            region = (0, T, 0, H, 0, W)
        rt0, rt1, ri0, ri1, rj0, rj1 = region
        if not (0 <= rt0 < rt1 <= T and 0 <= ri0 < ri1 <= H
                and 0 <= rj0 < rj1 <= W):
            raise ValueError(f"region {region} outside field "
                             f"({T}, {H}, {W})")
        ex = pipeline.executor_from_header(hdr, dev, backend)
        u_out = np.zeros((rt1 - rt0, ri1 - ri0, rj1 - rj0), dtype=np.float32)
        v_out = np.zeros_like(u_out)
        entries = _plan_entries(hdr, region)
        report.n_units = len(entries)
        failures = [] if degraded else None
        if (rt0, rt1, ri0, ri1, rj0, rj1) == (0, T, 0, H, 0, W):
            # a full decode: one unit resident at a time, and the cache
            # left alone (a whole field of patches would evict every
            # entry that has a chance of reuse)
            def decoded_iter():
                for entry in entries:
                    try:
                        uh, secs = source.unit(entry, ex.device)
                        u_rec, v_rec = ex.decode_unit(uh, secs)
                    except encode.ContainerError as e:
                        if failures is None:
                            raise
                        failures.append((entry, e))
                        continue
                    yield tuple(uh["box"]), u_rec, v_rec
            decoded = decoded_iter()
        else:
            decoded, _ = query.fetch_decoded_units(source, ex, entries,
                                                   failures=failures)
        for box, u_rec, v_rec in decoded:
            t0, t1, i0, i1, j0, j1 = box
            ct0, ct1 = max(t0, rt0), min(t1, rt1)
            ci0, ci1 = max(i0, ri0), min(i1, ri1)
            cj0, cj1 = max(j0, rj0), min(j1, rj1)
            src_sl = (slice(ct0 - t0, ct1 - t0), slice(ci0 - i0, ci1 - i0),
                      slice(cj0 - j0, cj1 - j0))
            dst = (slice(ct0 - rt0, ct1 - rt0), slice(ci0 - ri0, ci1 - ri0),
                   slice(cj0 - rj0, cj1 - rj0))
            u_out[dst] = u_rec[src_sl]
            v_out[dst] = v_rec[src_sl]
            report.n_decoded += 1
        if failures:
            report.missing_units = [
                {"key": tuple(e["key"]), "box": tuple(e["box"]),
                 "error": str(err)} for e, err in failures]
    if degraded:
        from . import faults

        report.retries = faults.retry_stats()
        return u_out, v_out, report
    return u_out, v_out


def decompress_region(src, region, backend=None, degraded=False, *,
                      device=None):
    """Random-access decode of (t0, t1, i0, i1, j0, j1): reads only the
    units covering the region (cached across repeated queries).
    ``backend`` as in ``decompress_tiled``; ``degraded=True`` reports
    damaged units instead of raising."""
    return decompress_tiled(src, region=region, backend=backend,
                            degraded=degraded, device=device)
