"""Plan autotuning of the port against the JAX package (CPU).

On the CPU the port searches the reference's off-TPU backend arms
("xla", "numpy"): its candidate list must be the reference's field for
field, backend included, every candidate priced float for float as the
reference prices it under one table in the reference's own (backend,
stage) keys, and its ranking the reference's.  A tuned config writes
the bytes of the same plan set by hand and of the reference's tuned
plan, its header's ``sl_backend`` the chosen arm.  The calibration
table has its own format (version 2, per (backend, stage)); a version-1
table is refused as stale and the reference's table as foreign.
Mirrors tests/test_autotune.py except its wall-clock gate.
"""
import pytest

pytest.importorskip("torch")

import dataclasses
import importlib
import json

import numpy as np
import torch

import repro.core as core
from repro import autotune as r_autotune
import repro_torch
from repro_torch import autotune
from repro_torch.core import encode

r_costmodel = importlib.import_module("repro.autotune.costmodel")
r_search = importlib.import_module("repro.autotune.search")
r_calibrate = importlib.import_module("repro.autotune.calibrate")
costmodel = importlib.import_module("repro_torch.autotune.costmodel")
search_mod = importlib.import_module("repro_torch.autotune.search")
calibrate_mod = importlib.import_module("repro_torch.autotune.calibrate")

SHAPES = ((4, 24, 24), (6, 32, 32))
# monolithic / tiled-only / stream workloads of the reference's tests
WORKLOADS = [((8, 40, 40), False, 0.0), ((6, 32, 32), False, 0.0),
             ((120, 100, 225), False, 0.0), ((16, 48, 48), True, 0.0),
             ((16, 64, 64), True, 0.25)]


def _field(shape, seed=3):
    rng = np.random.default_rng(seed)
    base = np.cumsum(rng.normal(size=shape).astype(np.float32), axis=0)
    return base, base[::-1].copy()


def _ref_coeffs(mono=1.0, favour=None):
    """The reference test's fixed table, for both of its CPU backends;
    ``mono`` scales the monolithic stages (1000 makes a tiled plan
    win), and the arm ``favour`` costs half of the others."""
    return {(be, stage): (1e-4 * (i + 1) * (mono if i < 5 else 1.0)
                          * (0.5 if be == favour else 1.0),
                          1e-8 * (i + 2) * (mono if i < 5 else 1.0)
                          * (0.5 if be == favour else 1.0))
            for be in ("xla", "numpy")
            for i, stage in enumerate(r_costmodel.STAGES)}


def _table(mono=1.0, favour=None):
    """The same coefficients in a port table (the same keys)."""
    return autotune.CalibrationTable(device_kind="cpu",
                                     coeffs=_ref_coeffs(mono, favour))


def _fields(c):
    """A candidate's fields in order (either package's)."""
    return dataclasses.astuple(c)


def _models(favour=None):
    coeffs = _ref_coeffs(favour=favour)
    return (r_costmodel.CostModel(coeffs=coeffs, kind="cpu"),
            autotune.CostModel(coeffs=coeffs, kind="cpu"))


def _sl_tag(blob):
    """The header's ``sl_backend`` of a monolithic or tiled container."""
    if encode.is_tiled(blob):
        return encode.tiled_header(blob)["sl_backend"]
    return encode.unpack(blob)[0]["sl_backend"]


# ----------------------------------------------------------------------
# cost model and search against the reference
# ----------------------------------------------------------------------

@pytest.mark.parametrize("shape,stream,ingest", WORKLOADS)
def test_candidates_and_predictions_equal_reference(shape, stream, ingest):
    # the reference's default arms off a TPU are the port's CPU arms
    ref = r_search.enumerate_candidates(shape, stream=stream)
    port = search_mod.enumerate_candidates(shape, stream=stream,
                                           device="cpu")
    assert [_fields(c) for c in ref] == [_fields(c) for c in port]
    assert port == search_mod.enumerate_candidates(
        shape, stream=stream, backends=autotune.available_backends("cpu"))
    assert {c.backend for c in port} == {"xla", "numpy"}
    rwl = r_costmodel.Workload(*shape, stream=stream, ingest_s=ingest)
    pwl = costmodel.Workload(*shape, stream=stream, ingest_s=ingest)
    for favour in (None, "xla"):
        rm, pm = _models(favour)
        for a, b in zip(ref, port):
            assert rm.predict(a, rwl) == pm.predict(b, pwl)


@pytest.mark.parametrize("favour", [None, "xla"])
@pytest.mark.parametrize("shape,stream,ingest", WORKLOADS)
def test_ranking_equals_reference_and_ignores_input_order(shape, stream,
                                                          ingest, favour):
    rm, pm = _models(favour)
    ref = r_search.search(shape, model=rm, stream=stream, ingest_s=ingest)
    cands = search_mod.enumerate_candidates(shape, stream=stream,
                                            device="cpu")
    fwd = autotune.search(shape, model=pm, stream=stream, ingest_s=ingest,
                          candidates=cands)
    rev = autotune.search(shape, model=pm, stream=stream, ingest_s=ingest,
                          candidates=cands[::-1])
    dflt = autotune.search(shape, model=pm, stream=stream, ingest_s=ingest,
                           device="cpu")
    assert [_fields(r.cand) for r in ref] == [_fields(r.cand) for r in fwd]
    assert [r.cand for r in fwd] == [r.cand for r in rev] \
        == [r.cand for r in dflt]
    # an even table ties the arms, and the key breaks ties to "numpy"
    assert fwd[0].cand.backend == (favour or "numpy")
    if stream:
        assert all(r.cand.grid is not None for r in fwd)


def test_seeds_exist_for_every_stage_and_kind():
    for kind in ("gpu", "cpu"):
        for be in ("pallas", "xla", "numpy"):
            seeds = costmodel.seed_coeffs(kind, be)
            assert set(seeds) == set(costmodel.STAGES)
            assert all(c0 > 0 and c1 > 0 for c0, c1 in seeds.values())
    # the CPU seeds are the reference's for both CPU arms (numpy scaled),
    # the card's one H100 row for all three tags
    for be in ("xla", "numpy"):
        assert costmodel.seed_coeffs("cpu", be) \
            == r_costmodel.seed_coeffs("cpu", be)
    assert costmodel.seed_coeffs("cpu", "numpy") \
        != costmodel.seed_coeffs("cpu", "xla")
    assert costmodel.seed_coeffs("gpu", "numpy") \
        == costmodel.seed_coeffs("gpu", "xla") \
        == costmodel.seed_coeffs("gpu", "pallas")
    # the uncalibrated model prices every stage from the seeds
    m = autotune.CostModel(kind="gpu")
    assert m.coeff("xla", "pack") \
        == costmodel.seed_coeffs("gpu", "xla")["pack"]
    # and an uncalibrated CPU tune ranks as the reference's does
    shape = (6, 32, 32)
    ref = r_search.search(shape, model=r_costmodel.CostModel(kind="cpu"))
    port = autotune.search(shape, model=autotune.CostModel(kind="cpu"),
                           device="cpu")
    assert [_fields(r.cand) for r in ref] == [_fields(r.cand) for r in port]


def test_candidates_carry_no_backend_and_apply_leaves_it_unset(monkeypatch):
    """Candidates carry the arm (the SL stepper's header tag) and
    ``apply`` writes it into ``cfg.backend``, overriding the caller's;
    the "numpy" arm stays ``backend=None`` (its kernels on CUDA), and
    is left out, and refused by ``apply``, while REPRO_BACKEND names
    another stepper."""
    cands = autotune.enumerate_candidates((16, 64, 64), stream=True,
                                          device="cpu")
    assert {c.backend for c in cands} == {"xla", "numpy"}
    assert {c.codec for c in cands} == {"host", "device"}
    assert any(c.async_engine for c in cands)
    base = repro_torch.CompressionConfig(backend="pallas")
    for tag, want in (("numpy", None), ("xla", "xla"),
                      ("pallas", "pallas")):
        cand = dataclasses.replace(cands[-1], backend=tag)
        cfg = autotune.apply(base, cand)
        assert cfg.backend == want and cfg.tiling is not None
        assert base.backend == "pallas"
    assert autotune.PlanCandidate(backend="xla").describe() == "mono/xla/host"
    with pytest.raises(ValueError, match="unknown backend"):
        autotune.apply(base, autotune.PlanCandidate(backend="tpu"))
    monkeypatch.setenv("REPRO_BACKEND", "xla")
    assert autotune.available_backends("cpu") == ("xla",)
    assert {c.backend for c in autotune.enumerate_candidates(
        (6, 32, 32), device="cpu")} == {"xla"}
    with pytest.raises(ValueError, match="REPRO_BACKEND"):
        autotune.apply(base, autotune.PlanCandidate(backend="numpy"))
    assert autotune.apply(base, autotune.PlanCandidate()).backend == "xla"


@pytest.mark.parametrize("env,cpu,cuda", [
    (None, ("xla", "numpy"), ("pallas", "xla", "numpy")),
    ("numpy", ("xla", "numpy"), ("pallas", "xla", "numpy")),
    ("xla", ("xla",), ("pallas", "xla")),
    ("pallas", ("xla",), ("pallas", "xla")),
])
def test_available_backends_follow_the_device(monkeypatch, env, cpu, cuda):
    if env is None:
        monkeypatch.delenv("REPRO_BACKEND", raising=False)
    else:
        monkeypatch.setenv("REPRO_BACKEND", env)
    assert autotune.available_backends("cpu") == cpu
    # resolve_device asks torch whether CUDA is there, nothing more
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert autotune.available_backends() == cuda
    assert autotune.available_backends("cuda") == cuda
    assert {c.backend for c in autotune.enumerate_candidates(
        (6, 32, 32), device="cuda")} == set(cuda)


def test_device_kind_follows_the_device(monkeypatch):
    assert autotune.device_kind("cpu") == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune.device_kind()


# ----------------------------------------------------------------------
# tuned containers
# ----------------------------------------------------------------------

def _ref_tuned(u, v, cfg_kw, mono, favour):
    return r_autotune.tune_config(
        u, v, core.CompressionConfig(**cfg_kw),
        table=r_autotune.CalibrationTable(device_kind="cpu",
                                          coeffs=_ref_coeffs(mono, favour)),
        measure=False)


def _plan(cfg):
    """A config's fields but the backend, its grid as a tuple."""
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
           if f.name != "backend"}
    g = out["tiling"]
    out["tiling"] = None if g is None else (g.tile_h, g.tile_w, g.window_t)
    return out


def _ref_compress(u, v, cfg):
    if cfg.tiling is None:
        return core.compress(u, v, cfg)[0]
    return core.compress_tiled(u, v, cfg, cfg.tiling)[0]


@pytest.mark.parametrize("shape,cfg_kw,mono,favour,chosen", [
    ((6, 32, 32), dict(eb=1e-2, track_index=False), 1.0, None,
     "mono/numpy/host"),
    ((16, 16, 16), dict(eb=1e-2, codec="device"), 1000.0, None,
     "8x16x16/numpy/device/cap4"),
    # the one reference "xla" compile of the module (5-20 s)
    ((6, 32, 32), dict(eb=1e-2, track_index=False, backend="pallas"), 1.0,
     "xla", "mono/xla/host"),
])
def test_tuned_plan_bytes_equal_hand_set_and_reference(shape, cfg_kw, mono,
                                                       favour, chosen):
    u, v = _field(shape)
    tuned = autotune.tune_config(u, v, repro_torch.CompressionConfig(**cfg_kw),
                                 table=_table(mono, favour), measure=False,
                                 device="cpu")
    assert autotune.last_report()["chosen"] == chosen
    ref = _ref_tuned(u, v, cfg_kw, mono, favour)
    arm = favour or "numpy"
    assert ref.backend == arm
    assert tuned.backend == (None if arm == "numpy" else arm)
    assert _plan(tuned) == _plan(ref)
    blob, _ = repro_torch.compress(u, v, tuned, device="cpu")
    assert _sl_tag(blob) == arm
    hand = repro_torch.CompressionConfig(**dict(
        cfg_kw, backend=tuned.backend, codec=tuned.codec,
        batch_cap=tuned.batch_cap, tiling=tuned.tiling))
    if hand.tiling is None:
        blob_hand, _ = repro_torch.compress(u, v, hand, device="cpu")
    else:
        blob_hand, _ = repro_torch.compress_tiled(u, v, hand, hand.tiling,
                                                  device="cpu")
    assert blob == blob_hand == _ref_compress(u, v, ref)


def test_compress_autotune_entry_point(monkeypatch):
    u, v = _field((4, 24, 24))
    monkeypatch.setattr(autotune, "load_or_calibrate",
                        lambda path=None, device=None: _table())
    cfg = repro_torch.CompressionConfig(eb=1e-2, track_index=False)
    blob, stats = repro_torch.compress(u, v, cfg, autotune=True,
                                       device="cpu")
    assert blob and stats["ratio"] > 0
    rep = autotune.last_report()
    assert rep is not None and rep["device_kind"] == "cpu" \
        and rep["calibrated"] and not rep["stream"]
    measured = [p for p in rep["plans"] if p["measured_s"] is not None]
    assert len(measured) == 3 and rep["plans"][0]["chosen"]
    assert "<= chosen" in autotune.explain()
    chosen = autotune.tune_config(u, v, cfg, table=_table(), measure=False,
                                  device="cpu")
    assert autotune.last_report()["plans"][0]["measured_s"] is None
    assert chosen.backend is None


def test_measure_sample_equals_reference():
    r_init = importlib.import_module("repro.autotune")
    for shape in ((120, 100, 225), (64, 512, 512), (6, 32, 32)):
        u = np.broadcast_to(np.float32(0), shape)
        assert autotune._sample(u, u)[0].shape \
            == r_init._sample(u, u)[0].shape
    assert autotune._sample(u, u)[0].shape[0] == 6


def test_compress_stream_autotune_equals_tiled_with_chosen_plan(monkeypatch):
    u, v = _field((6, 32, 32))
    monkeypatch.setattr(autotune, "load_or_calibrate",
                        lambda path=None, device=None: _table())
    cfg = repro_torch.CompressionConfig(eb=1e-2, track_index=False)
    gen = ((u[t], v[t]) for t in range(u.shape[0]))
    blob, stats = repro_torch.compress_stream(gen, cfg, autotune=True,
                                              n_frames_hint=6, device="cpu")
    rep = autotune.last_report()
    assert rep["stream"] and rep["shape"] == (6, 32, 32)
    tuned, cand = autotune.tune_stream((6, 32, 32), cfg, table=_table(),
                                       device="cpu")
    assert stats["async_engine"] is cand.async_engine
    want, _ = repro_torch.compress_tiled(u, v, tuned, tuned.tiling,
                                         device="cpu")
    assert blob == want


def test_autotune_refused_on_resume():
    with pytest.raises(ValueError, match="resume"):
        repro_torch.compress_stream(iter(()), autotune=True, resume=True,
                                    value_range=(0.0, 1.0), device="cpu")


def test_scheduling_knobs_never_change_bytes():
    u, v = _field((6, 32, 32))
    grid = repro_torch.TileGrid(tile_h=16, tile_w=16, window_t=3)
    base = repro_torch.CompressionConfig(eb=1e-2, track_index=False)
    blobs = {repro_torch.compress_tiled(
        u, v, dataclasses.replace(base, batch_cap=cap), grid,
        device="cpu")[0] for cap in (1, 3, 8)}
    assert len(blobs) == 1


# ----------------------------------------------------------------------
# calibration and its table
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def table(tmp_path_factory):
    """One real calibration of the "numpy" arm on the CPU (the port's
    plain versions), as the reference's test calibrates."""
    path = str(tmp_path_factory.mktemp("calib") / "table.json")
    return autotune.calibrate(shapes=SHAPES, backends=("numpy",), path=path,
                              device="cpu")


def test_calibration_fits_every_stage(table):
    assert table.device_kind == "cpu"
    assert set(table.coeffs) == {("numpy", s) for s in costmodel.STAGES}
    assert all(c0 >= 0 and c1 >= 0 for c0, c1 in table.coeffs.values())
    assert table.meta["backends"] == ["numpy"]


def test_calibration_restores_tracing_state(table):
    """Also the one two-arm calibration: both CPU arms by default, each
    fitted on its own stepper's runs."""
    from repro_torch import obs

    was = obs.enabled()
    two = autotune.calibrate(shapes=((4, 16, 16), (4, 24, 24)), save=False,
                             device="cpu")
    assert obs.enabled() == was
    assert two.meta["backends"] == ["xla", "numpy"]
    assert set(two.coeffs) == {(be, s) for be in ("xla", "numpy")
                               for s in costmodel.STAGES}
    assert all(c0 >= 0 and c1 >= 0 for c0, c1 in two.coeffs.values())


def test_saved_table_reloads_identically(table, tmp_path):
    p = str(tmp_path / "roundtrip.json")
    autotune.save_table(table, p)
    got = autotune.load_table(p, device="cpu")
    assert got.coeffs == table.coeffs and got.device_kind == "cpu"
    with open(p) as f:
        payload = json.load(f)
    assert payload["version"] == calibrate_mod.TABLE_VERSION == 2
    assert {(e["backend"], e["stage"]) for e in payload["entries"]} \
        == set(table.coeffs)


class TestTableVersioning:
    def _write(self, path, **overrides):
        payload = {
            "format": calibrate_mod.TABLE_FORMAT,
            "version": calibrate_mod.TABLE_VERSION,
            "device_kind": "cpu",
            "meta": {},
            "entries": [{"backend": "numpy", "stage": "derive_eb",
                         "c0": 1e-4, "c1": 1e-8}],
        }
        payload.update(overrides)
        path.write_text(json.dumps(payload))
        return str(path)

    def test_good_table_roundtrips(self, tmp_path):
        t = autotune.load_table(self._write(tmp_path / "ok.json"),
                                device="cpu")
        assert t.coeffs[("numpy", "derive_eb")] == (1e-4, 1e-8)

    @pytest.mark.parametrize("overrides,reason", [
        (dict(version=calibrate_mod.TABLE_VERSION + 1), "stale"),
        # a table of the port before the backend arm: keyed by device kind
        (dict(version=1, entries=[{"device": "cpu", "stage": "pack",
                                   "c0": 1e-4, "c1": 1e-8}]), "stale"),
        (dict(device_kind="gpu"), "foreign"),
        (dict(format="something"), "corrupt"),
        (dict(entries=[{"stage": "pack"}]), "corrupt"),
    ])
    def test_refused_typed(self, tmp_path, overrides, reason):
        p = self._write(tmp_path / "t.json", **overrides)
        with pytest.raises(autotune.CalibrationTableError) as ei:
            autotune.load_table(p, device="cpu")
        assert ei.value.reason == reason
        assert isinstance(ei.value, ValueError)

    def test_unparseable_refused(self, tmp_path):
        p = tmp_path / "bad.json"
        p.write_text("{not json")
        with pytest.raises(autotune.CalibrationTableError) as ei:
            autotune.load_table(str(p), device="cpu")
        assert ei.value.reason == "corrupt"

    def test_reference_table_refused(self, tmp_path):
        p = str(tmp_path / "jax.json")
        r_calibrate.save_table(r_calibrate.CalibrationTable(
            device_kind="cpu", coeffs=_ref_coeffs()), p)
        with pytest.raises(autotune.CalibrationTableError) as ei:
            autotune.load_table(p, device="cpu")
        assert ei.value.reason == "foreign"

    def test_default_path_is_the_port_own(self):
        assert autotune.default_table_path() \
            != r_calibrate.default_table_path()
        assert "repro_torch" in autotune.default_table_path()

    @pytest.mark.parametrize("what", ["stale", "missing", "reference"])
    def test_refused_table_triggers_recalibration(self, tmp_path,
                                                  monkeypatch, what):
        p = str(tmp_path / "t.json")
        if what == "stale":
            self._write(tmp_path / "t.json",
                        version=calibrate_mod.TABLE_VERSION + 1)
        elif what == "reference":
            r_calibrate.save_table(r_calibrate.CalibrationTable(
                device_kind="cpu", coeffs=_ref_coeffs()), p)
        fresh = _table()
        called = {}

        def fake_calibrate(path=None, device=None, **kw):
            called["path"], called["device"] = path, device
            return fresh

        monkeypatch.setattr(calibrate_mod, "calibrate", fake_calibrate)
        out = calibrate_mod.load_or_calibrate(p, device="cpu")
        assert out is fresh and called == {"path": p, "device": "cpu"}
