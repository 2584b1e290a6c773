"""Analytic per-stage cost model over pipeline plans (the JAX package's
``autotune/costmodel.py``).

Every stage cost is the two-term affine model

    t_stage = c0 * n_dispatches + c1 * n_elements

where ``c0`` prices per-dispatch overhead (host work and kernel launches
of one stage call) and ``c1`` per-element streaming work.  Uncalibrated,
the coefficients are *seeded* from roofline terms: each stage has a
(flops/element, bytes/element) intensity estimate -- the entropy stages'
weights are the non-dot op weights of the JAX package's HLO cost model
(gather, reduce, reduce-window), since a dot-dominated FLOP count
misprices exactly those ops -- and ``c1`` is the roofline max of compute
and memory time at the device kind's peak rates.  Calibration
(calibrate.py) replaces the seeds with coefficients fitted to measured
``obs`` span durations; seeds only have to rank candidates sensibly
until a calibration table exists.

The device of the call fixes what runs (kernels on CUDA, their plain
versions on the CPU) and the candidate's backend which SL stepper runs,
so coefficients are keyed by (backend, stage), with the device kind on
the model and on its calibration table.  The CPU seeds are the JAX
package's, "numpy" rates scaled by ``_NUMPY_RATE_SCALE``, so an
uncalibrated CPU tune ranks as the reference's does.  The "gpu" seeds
are one H100 row for all three tags: the SL kernels are under 1 % of an
encode on the card, so no seed can honestly tell the tags apart, and an
uncalibrated card tune picks the "numpy" arm by the key tie-break.  The
model never touches container bytes: it only orders candidate plans by
predicted wall time.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..core import compressor

# model stages <-> the obs spans they are calibrated from
# (monolithic pipeline spans and tiled-path spans are separate stages:
# they run different code with different dispatch granularity)
STAGES = (
    "derive_eb",        # pipeline.derive_eb (monolithic)
    "quantize_predict",  # pipeline.quantize_predict (monolithic)
    "verify_round",     # pipeline.verify_round (monolithic)
    "symbolize",        # pipeline.symbolize (host codec)
    "pack",             # pipeline.pack (host codec)
    "tiled_derive",     # tiling.derive_window
    "tiled_verify",     # tiling.verify_round
    "tiled_encode",     # tiling.unit_payloads (final-mask encode)
    "tiled_write",      # tiling.write_units (symbolize+pack+container)
    "tiled_entropy",    # tiling.entropy_fragments (device codec)
)

# the non-dot op weights of the JAX package's HLO cost model
# (src/repro/hlocost.py NONDOT_FLOP_WEIGHTS) that the entropy stages use
NONDOT_FLOP_WEIGHTS = {"gather": 4.0, "reduce": 2.0, "reduce-window": 8.0}

# stage intensity seeds: (flops/element, bytes/element).  symbolize is
# gather-shaped (escape routing), table build reduce/histogram-shaped,
# bit-pack a prefix-sum pass.
_W = NONDOT_FLOP_WEIGHTS
STAGE_INTENSITY = {
    "derive_eb": (48.0, 40.0),
    "quantize_predict": (64.0, 56.0),
    "verify_round": (96.0, 72.0),
    "symbolize": (_W["gather"] + _W["reduce"], 12.0),
    "pack": (_W["reduce-window"] + _W["reduce"], 10.0),
    "tiled_derive": (48.0, 40.0),
    "tiled_verify": (96.0, 72.0),
    "tiled_encode": (64.0, 56.0),
    "tiled_write": (_W["gather"] + _W["reduce-window"], 12.0),
    "tiled_entropy": (_W["gather"] + _W["reduce"] + _W["reduce-window"],
                      8.0),
}

# device-kind peak rates: (flops/s, bytes/s, dispatch overhead s).
# gpu: the H100 SXM data sheet (34 TFLOP/s f64 outside the tensor cores,
# 3.35 TB/s HBM3); its dispatch term is the host cost of one kernel
# call measured on an H100 80GB HBM3 at 700 W (K5: 0.03141 ms a call
# against 0.00644 ms of device time, PERF.md section 6).  cpu: a modest
# single-socket estimate (the JAX package's cpu row); seeds only need a
# sane ordering, calibration supplies real magnitudes.
DEVICE_RATES = {
    "gpu": (34e12, 3.35e12, 0.03141e-3 - 0.00644e-3),
    "cpu": (5e10, 2e10, 120e-6),
}
# the JAX package's numpy backend skips jit dispatch: cheaper per call,
# slower per element than fused XLA CPU code (the CPU row only)
_NUMPY_RATE_SCALE = (0.5, 1.0, 0.15)


def device_kind(device=None) -> str:
    """'gpu' for a CUDA device, else 'cpu': the calibration-table key
    that makes a table foreign on other hardware.  ``device=None`` is
    the CUDA device (compressor.resolve_device)."""
    return "gpu" if compressor.resolve_device(device).type == "cuda" \
        else "cpu"


def seed_coeffs(kind: str, backend: str) -> dict:
    """Roofline-seeded {stage: (c0, c1)} for one (device kind, backend)."""
    peak_flops, mem_bw, disp = DEVICE_RATES.get(kind, DEVICE_RATES["cpu"])
    if backend == "numpy" and kind != "gpu":
        sf, sb, sd = _NUMPY_RATE_SCALE
        peak_flops, mem_bw, disp = peak_flops * sf, mem_bw * sb, disp * sd
    out = {}
    for stage in STAGES:
        f, b = STAGE_INTENSITY[stage]
        # roofline: the slower of the compute and memory terms bounds
        # the per-element time
        out[stage] = (disp, max(f / peak_flops, b / mem_bw))
    return out


@dataclasses.dataclass(frozen=True)
class Workload:
    """What the cost model prices a candidate against."""

    T: int
    H: int
    W: int
    verify_rounds: float = 2.0      # expected fixpoint rounds
    stream: bool = False
    # total producer latency over the stream (seconds): frames from a
    # paced source serialize with compute on the serial engine but
    # overlap with it on the async engine
    ingest_s: float = 0.0

    @property
    def elems(self) -> int:
        # both components
        return 2 * self.T * self.H * self.W


def _tile_counts(n: int, tile: int):
    """(tiles, distinct extents) along one axis for tile size ``tile``."""
    nt = -(-n // tile)
    # interior tiles share one extent; a ragged last tile adds another
    distinct = 1 if n % tile == 0 or nt == 1 else 2
    return nt, distinct


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Derived unit geometry for one candidate on one workload."""

    n_windows: int
    n_units: int
    n_sig_groups: int        # signature-group fan-out per window
    unit_ext_elems: int      # halo-extended elements per unit (u+v)
    unit_owned_elems: int    # owned elements per unit (u+v)
    tiles_per_window: int


def geometry(wl: Workload, grid) -> Optional[Geometry]:
    """Geometry for a (tile_h, tile_w, window_t) triple; None for the
    monolithic (untiled) candidate."""
    if grid is None:
        return None
    th, tw, wt = grid
    nw = -(-wl.T // wt)
    nti, dh = _tile_counts(wl.H, th)
    ntj, dw = _tile_counts(wl.W, tw)
    # window-length variety: a ragged last window adds a group set
    dt = 1 if wl.T % wt == 0 or nw == 1 else 2
    ext = (min(wt, wl.T) + 2) * (min(th, wl.H) + 2) * (min(tw, wl.W) + 2)
    owned = min(wt, wl.T) * min(th, wl.H) * min(tw, wl.W)
    return Geometry(
        n_windows=nw,
        n_units=nw * nti * ntj,
        n_sig_groups=max(dh * dw * dt, 1),
        unit_ext_elems=2 * ext,
        unit_owned_elems=2 * owned,
        tiles_per_window=nti * ntj,
    )


class CostModel:
    """Predict per-stage and total encode cost for a candidate.

    ``coeffs`` maps (backend, stage) -> (c0, c1); missing entries fall
    back to the roofline seeds of the model's device kind.
    """

    def __init__(self, coeffs: Optional[dict] = None,
                 kind: Optional[str] = None):
        self.kind = kind or device_kind()
        self.coeffs = dict(coeffs or {})
        self._seeds = {}

    def coeff(self, backend: str, stage: str):
        c = self.coeffs.get((backend, stage))
        if c is not None:
            return c
        seeds = self._seeds.get(backend)
        if seeds is None:
            seeds = self._seeds[backend] = seed_coeffs(self.kind, backend)
        return seeds[stage]

    def _term(self, backend: str, stage: str, n_disp: float,
              n_elems: float) -> float:
        c0, c1 = self.coeff(backend, stage)
        return c0 * n_disp + c1 * n_elems

    def predict(self, cand, wl: Workload) -> dict:
        """{"stages": {stage: seconds}, "total": seconds} for one
        candidate (search.PlanCandidate) on one workload."""
        be = cand.backend
        rounds = max(wl.verify_rounds, 1.0)
        stages = {}
        if cand.grid is None:
            # monolithic fused pipeline: one dispatch per stage, the
            # verify loop re-dispatches per round
            e = wl.elems
            stages["derive_eb"] = self._term(be, "derive_eb", 1, e)
            stages["quantize_predict"] = self._term(
                be, "quantize_predict", 1, e)
            stages["verify_round"] = self._term(
                be, "verify_round", rounds, rounds * e)
            stages["symbolize"] = self._term(be, "symbolize", 2, e)
            stages["pack"] = self._term(be, "pack", 2, e)
            total = sum(stages.values())
        else:
            g = geometry(wl, cand.grid)
            ext_total = g.n_units * g.unit_ext_elems
            owned_total = g.n_units * g.unit_owned_elems
            # batched execution chunks each signature group by batch_cap
            if cand.batch_units:
                per_w = sum(
                    -(-max(g.tiles_per_window // g.n_sig_groups, 1)
                      // cand.batch_cap)
                    for _ in range(g.n_sig_groups))
                n_batches = g.n_windows * per_w
            else:
                n_batches = g.n_units
            stages["tiled_derive"] = self._term(
                be, "tiled_derive", g.n_windows, ext_total)
            stages["tiled_verify"] = self._term(
                be, "tiled_verify", rounds * n_batches, rounds * ext_total)
            stages["tiled_encode"] = self._term(
                be, "tiled_encode", n_batches, ext_total)
            if cand.codec == "device":
                stages["tiled_entropy"] = self._term(
                    be, "tiled_entropy", g.n_windows * g.n_sig_groups,
                    owned_total)
                # container write still runs, minus the host Huffman
                stages["tiled_write"] = 0.25 * self._term(
                    be, "tiled_write", g.n_units, owned_total)
            else:
                stages["tiled_write"] = self._term(
                    be, "tiled_write", g.n_units, owned_total)
            total = sum(stages.values())
            if wl.stream:
                if cand.async_engine:
                    # three-stage overlap: ingest, compute and emit run
                    # concurrently, so the pipeline time approaches the
                    # slowest group plus a small coordination cost;
                    # undersized handoff queues reintroduce stalls
                    compute = (stages["tiled_derive"]
                               + stages["tiled_verify"]
                               + stages["tiled_encode"])
                    emit = total - compute
                    overlapped = max(wl.ingest_s, compute, emit) \
                        + 0.05 * total
                    q_out = cand.q_out_units or 2 * g.tiles_per_window
                    if q_out < g.tiles_per_window:
                        overlapped += 0.10 * total
                    q_in = cand.q_in_frames or max(cand.grid[2], 2)
                    if q_in < 2:
                        overlapped += 0.05 * total
                    total = overlapped
                else:
                    # serial engine: producer latency serializes with
                    # every downstream stage
                    total += wl.ingest_s
        return {"stages": stages, "total": total}
