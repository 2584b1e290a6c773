"""Cost-model-driven plan auto-tuning (the JAX package's
``repro.autotune``).

Pick the fastest pipeline plan for an input, calibrated from measured
obs spans:

    blob, stats = repro_torch.compress(u, v, cfg, autotune=True)
    print(repro_torch.autotune.explain())

``tune_config`` enumerates the discrete plan space (search.py), ranks
it with the analytic cost model (costmodel.py) seeded from roofline
terms and calibrated against obs span measurements (calibrate.py), then
measure-verifies the top-k candidates on the actual field before
committing.  The chosen plan is returned as an ordinary
CompressionConfig: the pipeline is then exactly the one a user could
have configured by hand, so autotuning changes speed, never the bytes a
given plan produces.  Everything runs on ``device`` (the CUDA device
unless ``device="cpu"``); the device kind keys the calibration table,
whose coefficients are per (backend, stage).  The backend arm is the SL
stepper the plan runs and writes in its header: "pallas", "xla" and
"numpy" on CUDA, "xla" and "numpy" on the CPU (``available_backends``).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from ..core import compressor, ebpolicy, tiling
from .calibrate import (CalibrationTable, CalibrationTableError,
                        calibrate, default_table_path, load_or_calibrate,
                        load_table, save_table)
from .costmodel import CostModel, Workload, device_kind
from .rate import compress_with_target
from .search import PlanCandidate, apply, available_backends, \
    enumerate_candidates, search

__all__ = [
    "CalibrationTable", "CalibrationTableError", "CostModel",
    "PlanCandidate", "Workload", "apply", "available_backends",
    "calibrate", "compress_with_target", "default_table_path",
    "device_kind", "enumerate_candidates", "explain", "last_report",
    "load_or_calibrate", "load_table", "save_table", "search",
    "tune_config", "tune_stream",
]

# measure-verify the top-k model picks on the real field when it is
# small enough to rerun cheaply; above the cap measure a temporal
# subsample
_MEASURE_ELEMS_CAP = 2_000_000
_TOP_K = 3

_LAST_REPORT: Optional[dict] = None


def _measure_fn(u, v, cfg, device):
    """measure(cand) -> seconds: one untimed warm-up + one timed run of
    the candidate on the field.  A compress returns host bytes, so the
    timed run ends with the device's work done."""

    def measure(cand):
        c = apply(cfg, cand)

        def run():
            if c.tiling is None:
                return compressor.compress(u, v, c, device=device)
            return tiling.compress_tiled(u, v, c, c.tiling, device=device)
        run()  # warm-up: kernel builds and cached tables off the clock
        t0 = time.perf_counter()
        run()
        return time.perf_counter() - t0

    return measure


def _sample(u, v):
    """A temporally-subsampled stand-in field for measure-verify when
    the input is too large to rerun per candidate."""
    T = u.shape[0]
    step = max(T * u.shape[1] * u.shape[2] * 2 // _MEASURE_ELEMS_CAP, 1)
    tt = max(T // step, 4)
    return u[:tt], v[:tt]


def _policy_spec_of(cfg) -> tuple:
    """Canonical spec of cfg's eb policy, () for uniform."""
    return tuple(ebpolicy.policy_spec(
        ebpolicy.normalize(getattr(cfg, "eb_policy", None))) or ())


def _build_report(shape, stream, ranked, chosen, table, elapsed_s,
                  eb_policy=()):
    return {
        "shape": tuple(int(s) for s in shape),
        "stream": stream,
        # byte-changing plan knob the tune ran under (carried, never
        # searched); "uniform" when no policy was set
        "eb_policy": "adaptive" if eb_policy else "uniform",
        "device_kind": table.device_kind,
        "calibrated": bool(table.coeffs),
        "tune_time_s": elapsed_s,
        "chosen": chosen.cand.describe(),
        "plans": [
            {
                "plan": r.cand.describe(),
                "chosen": r.cand == chosen.cand,
                "predicted_s": r.predicted["total"],
                "predicted_stages": dict(r.predicted["stages"]),
                "measured_s": r.measured_s,
            }
            for r in ranked
        ],
    }


def tune_config(u, v, cfg, table: Optional[CalibrationTable] = None,
                measure: Optional[bool] = None, top_k: int = _TOP_K,
                device=None):
    """Return a new CompressionConfig running the predicted-fastest plan
    for field (u, v) on ``device``.  ``measure=None`` / True times the
    top-k candidates on the field (or a temporal subsample when it is
    large); ``measure=False`` trusts the model ranking outright."""
    global _LAST_REPORT
    dev = compressor.resolve_device(device)
    t0 = time.perf_counter()
    u = np.asarray(u)
    v = np.asarray(v)
    shape = u.shape
    if table is None:
        table = load_or_calibrate(device=dev)
    model = CostModel(coeffs=table.coeffs, kind=table.device_kind)
    if measure is None or measure:
        mu, mv = (u, v) if u.size * 2 <= _MEASURE_ELEMS_CAP \
            else _sample(u, v)
        measure_cb = _measure_fn(mu, mv, cfg, dev)
    else:
        measure_cb, top_k = None, 0
    pol_spec = _policy_spec_of(cfg)
    ranked = search(shape, model=model, top_k=top_k, measure=measure_cb,
                    eb_policy=pol_spec, device=dev)
    chosen = ranked[0]
    _LAST_REPORT = _build_report(shape, False, ranked, chosen, table,
                                 time.perf_counter() - t0,
                                 eb_policy=pol_spec)
    return apply(cfg, chosen.cand)


def tune_stream(shape, cfg, table: Optional[CalibrationTable] = None,
                ingest_s_per_frame: float = 0.0, device=None):
    """Model-only tuning for the streaming path (a stream cannot be
    rerun per candidate).  ``shape`` is the (T, H, W) the stream will
    deliver (T may be an estimate); ``ingest_s_per_frame`` is the
    producer's per-frame latency, the term that makes the async engine
    worth its coordination cost.  Returns (new cfg, chosen
    PlanCandidate); the cfg's grid is always set."""
    global _LAST_REPORT
    t0 = time.perf_counter()
    if table is None:
        table = load_or_calibrate(device=device)
    model = CostModel(coeffs=table.coeffs, kind=table.device_kind)
    pol_spec = _policy_spec_of(cfg)
    ranked = search(tuple(shape), model=model, stream=True,
                    ingest_s=ingest_s_per_frame * shape[0],
                    eb_policy=pol_spec, device=device)
    chosen = ranked[0]
    _LAST_REPORT = _build_report(tuple(shape), True, ranked, chosen,
                                 table, time.perf_counter() - t0,
                                 eb_policy=pol_spec)
    return apply(cfg, chosen.cand), chosen.cand


def last_report() -> Optional[dict]:
    """The raw report dict of the most recent tune (or None)."""
    return _LAST_REPORT


def explain(report: Optional[dict] = None, limit: int = 8) -> str:
    """Human-readable predicted-vs-measured account of the last tune:
    the chosen plan first, then the best rejected candidates."""
    rep = report or _LAST_REPORT
    if rep is None:
        return "autotune: no tuning run recorded in this process"
    lines = [
        "autotune report: shape=%s %s device=%s (%s) tuned in %.3fs"
        % ("x".join(str(s) for s in rep["shape"]),
           "stream" if rep["stream"] else "in-memory",
           rep["device_kind"],
           "calibrated" if rep["calibrated"] else "seed coefficients",
           rep["tune_time_s"]),
        "eb policy: %s (byte-changing plan knob -- carried through the "
        "search, never enumerated)" % rep.get("eb_policy", "uniform"),
        "%-28s %10s %10s  %s" % ("plan", "pred(s)", "meas(s)", ""),
    ]
    for p in rep["plans"][:limit]:
        meas = "%.4f" % p["measured_s"] if p["measured_s"] is not None \
            else "-"
        mark = "<= chosen" if p["chosen"] else ""
        lines.append("%-28s %10.4f %10s  %s"
                     % (p["plan"], p["predicted_s"], meas, mark))
        if p["chosen"]:
            for stage, s in sorted(p["predicted_stages"].items(),
                                   key=lambda kv: -kv[1]):
                lines.append("    %-24s %10.4f" % (stage, s))
    extra = len(rep["plans"]) - limit
    if extra > 0:
        lines.append("  ... %d more candidates pruned by the model"
                     % extra)
    return "\n".join(lines)
