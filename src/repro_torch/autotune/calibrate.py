"""Cost-model calibration from measured obs spans (the JAX package's
``autotune/calibrate.py``).

Protocol: run the real pipelines (monolithic fused + tiled, host and
device codecs) on a few small synthetic fields with tracing enabled,
read per-stage wall time from the ``span.*`` duration Histograms
(``obs.stage_durations``), and fit the two-term model

    t_stage = c0 * n_dispatches + c1 * n_elements

per (backend, stage) by least squares over the collected (dispatches,
elements, seconds) samples -- at least two field sizes, so c0 and c1
separate.  Each backend (SL stepper arm, search.available_backends) runs
the workload with the ``cfg.backend`` that ``search.apply`` writes for
it.  Tracing also synchronizes the device at the end of
each span (``obs.device_sync``), so a span holds its own stage's device
time.  Each run is warmed once first: on CUDA the warm run also builds
the kernels at first use, so nvcc time never enters a fit.

Coefficients persist to a versioned JSON table of this package's own
format, keyed by (device kind, backend, stage); a table of another
format version (version 1 keyed by device kind, without the backend) or
another device kind is refused with a typed ``CalibrationTableError``
(reason "stale" / "foreign"), never silently used.  The JAX package's table is refused as
"foreign" too: its coefficients price XLA stages, not these.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Optional

import numpy as np

from .. import obs
from ..core import compressor, tiling
from . import costmodel
from .search import available_backends, config_backend

TABLE_FORMAT = "repro_torch-autotune-calib"
TABLE_VERSION = 2
# the JAX package's table format: never read as this package's
REFERENCE_FORMAT = "repro-autotune-calib"

# span name -> model stage (costmodel.STAGES)
SPAN_STAGES = {
    "pipeline.derive_eb": "derive_eb",
    "pipeline.quantize_predict": "quantize_predict",
    "pipeline.verify_round": "verify_round",
    "pipeline.symbolize": "symbolize",
    "pipeline.pack": "pack",
    "tiling.derive_window": "tiled_derive",
    "tiling.verify_round": "tiled_verify",
    "tiling.unit_payloads": "tiled_encode",
    "tiling.write_units": "tiled_write",
    "tiling.entropy_fragments": "tiled_entropy",
}

# default calibration workload: two sizes so c0/c1 separate
CALIB_SHAPES = ((4, 24, 24), (8, 40, 40))


class CalibrationTableError(ValueError):
    """A calibration table that must not be used: wrong format/version
    (``reason="stale"``), wrong hardware or another package's table
    (``reason="foreign"``), or unparseable (``reason="corrupt"``)."""

    def __init__(self, msg: str, reason: str):
        super().__init__(msg)
        self.reason = reason


@dataclasses.dataclass
class CalibrationTable:
    """Fitted {(backend, stage): (c0, c1)} for one device kind."""

    device_kind: str
    coeffs: dict
    version: int = TABLE_VERSION
    meta: dict = dataclasses.field(default_factory=dict)


def default_table_path() -> str:
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "autotune_calib.json")


def save_table(table: CalibrationTable, path: Optional[str] = None) -> str:
    path = path or default_table_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "format": TABLE_FORMAT,
        "version": table.version,
        "device_kind": table.device_kind,
        "meta": table.meta,
        "entries": [
            {"backend": be, "stage": stage, "c0": c0, "c1": c1}
            for (be, stage), (c0, c1) in sorted(table.coeffs.items())
        ],
    }
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(payload, f, indent=1)
    os.replace(tmp, path)
    return path


def load_table(path: Optional[str] = None, expect_kind: Optional[str] = None,
               device=None) -> CalibrationTable:
    """Load and VALIDATE a persisted table for ``expect_kind`` (default:
    the kind of ``device``, the CUDA device unless ``device="cpu"``).
    Raises CalibrationTableError (typed, with ``.reason``) instead of
    ever returning a table this process must not use; a missing file
    raises FileNotFoundError."""
    path = path or default_table_path()
    try:
        with open(path) as f:
            payload = json.load(f)
    except FileNotFoundError:
        raise
    except (json.JSONDecodeError, OSError, UnicodeDecodeError) as e:
        raise CalibrationTableError(
            f"calibration table {path} is unreadable: {e}",
            reason="corrupt") from e
    fmt = payload.get("format") if isinstance(payload, dict) else None
    if fmt == REFERENCE_FORMAT:
        raise CalibrationTableError(
            f"{path} is the JAX package's calibration table ({fmt}); its "
            "coefficients price XLA stages -- recalibrate for this "
            "package", reason="foreign")
    if fmt != TABLE_FORMAT:
        raise CalibrationTableError(
            f"{path} is not a {TABLE_FORMAT} file", reason="corrupt")
    if payload.get("version") != TABLE_VERSION:
        raise CalibrationTableError(
            f"calibration table {path} has format version "
            f"{payload.get('version')}; this build expects "
            f"{TABLE_VERSION} -- recalibrate instead of reusing stale "
            "coefficients", reason="stale")
    kind = expect_kind or costmodel.device_kind(device)
    if payload.get("device_kind") != kind:
        raise CalibrationTableError(
            f"calibration table {path} was fitted on "
            f"{payload.get('device_kind')!r} hardware, this process runs "
            f"on {kind!r} -- foreign coefficients would invert the "
            "trade-offs; recalibrate", reason="foreign")
    coeffs = {}
    try:
        for e in payload["entries"]:
            coeffs[(e["backend"], e["stage"])] = (
                float(e["c0"]), float(e["c1"]))
    except (KeyError, TypeError, ValueError) as e:
        raise CalibrationTableError(
            f"calibration table {path} has malformed entries: {e}",
            reason="corrupt") from e
    return CalibrationTable(device_kind=payload["device_kind"],
                            coeffs=coeffs, version=payload["version"],
                            meta=payload.get("meta", {}))


def _fit(samples) -> tuple:
    """Least-squares (c0, c1) >= 0 from rows of (n_disp, n_elems, t)."""
    a = np.array([[r[0], r[1]] for r in samples], dtype=np.float64)
    t = np.array([r[2] for r in samples], dtype=np.float64)
    c0 = c1 = 0.0
    if len(samples) >= 2 and np.linalg.matrix_rank(a) == 2:
        sol, *_ = np.linalg.lstsq(a, t, rcond=None)
        c0, c1 = float(sol[0]), float(sol[1])
    if c0 < 0.0 or c1 < 0.0 or (c0 == 0.0 and c1 == 0.0):
        # degenerate fit: fall back to a pure per-element rate (and a
        # per-dispatch floor from the smallest observed dispatch)
        tot_e = sum(r[1] for r in samples)
        tot_d = sum(r[0] for r in samples)
        tot_t = sum(r[2] for r in samples)
        c1 = tot_t / tot_e if tot_e else 0.0
        c0 = 0.1 * tot_t / tot_d if tot_d else 0.0
    return c0, c1


def _workload_runs(shape):
    """The calibration runs for one shape: monolithic fused (host codec)
    + tiled host + tiled device, as [(kind, codec, grid)]."""
    T, H, W = shape
    grid = (max(H // 2, 8), max(W // 2, 8), max(T // 2, 2))
    return [("mono", "host", None), ("tiled", "host", grid),
            ("tiled", "device", grid)]


def _stage_elems(kind, stage, shape, grid):
    """Total elements the model charges a stage with for one run (must
    mirror costmodel.CostModel.predict's accounting)."""
    T, H, W = shape
    wl = costmodel.Workload(T=T, H=H, W=W)
    if kind == "mono":
        return wl.elems
    g = costmodel.geometry(wl, grid)
    if stage in ("tiled_write", "tiled_entropy"):
        return g.n_units * g.unit_owned_elems
    return g.n_units * g.unit_ext_elems


def calibrate(shapes=CALIB_SHAPES, backends=None, eb: float = 1e-2,
              path: Optional[str] = None, save: bool = True,
              device=None) -> CalibrationTable:
    """Run the calibration workload on ``device`` (the CUDA device unless
    ``device="cpu"``) once for each of ``backends`` (default
    ``available_backends(device)``) and fit a CalibrationTable.
    With ``save`` the table is persisted to ``path`` (default
    ~/.cache/repro_torch/autotune_calib.json)."""
    dev = compressor.resolve_device(device)
    backends = tuple(backends or available_backends(dev))
    kind = costmodel.device_kind(dev)
    samples = {}
    was_enabled = obs.enabled()
    try:
        obs.enable()
        for be in backends:
            for shape in shapes:
                T, H, W = shape
                rng = np.random.default_rng(7)
                base = np.cumsum(
                    rng.normal(size=(T, H, W)).astype(np.float32), axis=0)
                u, v = base, base[::-1].copy()
                for kind_run, codec, grid in _workload_runs(shape):
                    cfg = compressor.CompressionConfig(
                        eb=eb, mode="rel", predictor="mop",
                        backend=config_backend(be), fused=True,
                        codec=codec, track_index=False)
                    tg = None if grid is None else tiling.TileGrid(
                        tile_h=grid[0], tile_w=grid[1], window_t=grid[2])

                    def run():
                        if tg is None:
                            return compressor.compress(u, v, cfg,
                                                       device=dev)
                        return tiling.compress_tiled(u, v, cfg, tg,
                                                     device=dev)

                    # warm once (kernel builds, caches), then measure a
                    # clean run
                    run()
                    before = obs.stage_durations()
                    run()
                    after = obs.stage_durations()
                    for span, stage in SPAN_STAGES.items():
                        b = before.get(span, {"count": 0, "sum_s": 0.0})
                        a = after.get(span, {"count": 0, "sum_s": 0.0})
                        n = a["count"] - b["count"]
                        dt = a["sum_s"] - b["sum_s"]
                        if n <= 0 or dt <= 0:
                            continue
                        elems = _stage_elems(kind_run, stage, shape, grid)
                        samples.setdefault((be, stage), []).append(
                            (n, float(elems), dt))
    finally:
        obs.enable() if was_enabled else obs.disable()

    coeffs = {key: _fit(rows) for key, rows in samples.items()}
    table = CalibrationTable(
        device_kind=kind, coeffs=coeffs,
        meta={"shapes": [list(s) for s in shapes],
              "backends": list(backends), "eb": eb, "device": str(dev)})
    if save:
        save_table(table, path)
    return table


def load_or_calibrate(path: Optional[str] = None,
                      device=None) -> CalibrationTable:
    """The autotune entry point's table source: load the persisted
    table; on missing/stale/foreign/corrupt, run a fresh calibration on
    ``device`` (and persist it).  A refused table is counted, never
    used."""
    try:
        return load_table(path, device=device)
    except FileNotFoundError:
        obs.counter("autotune.table_miss").add(1)
    except CalibrationTableError as e:
        obs.counter(f"autotune.table_refused.{e.reason}").add(1)
    return calibrate(path=path, device=device)
