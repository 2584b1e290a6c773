"""The port's main path as a whole against the JAX package (CPU).

``repro_torch.compress(..., device="cpu")`` must write the bytes that
``repro.core.compress`` writes with its numpy SL stepper (the stepper
the port reproduces, and the tag it records), with the same verify
accounting; containers must cross-decode bitwise in both directions;
the checked-in v2 golden must decode bitwise; the trajectories must be
preserved (FC_t = FC_s = 0).  All comparisons are exact.
"""
import pytest

pytest.importorskip("torch")

import dataclasses
import os

import numpy as np

import repro.core as core
from repro.core import encode as r_encode
import repro_torch
from repro_torch.core import encode, metrics, trajectory
from repro_torch.data import synthetic

_VORTEX = (6, 32, 48)


def _vortex():
    u, v = synthetic.vortex_street(T=_VORTEX[0], H=_VORTEX[1], W=_VORTEX[2])
    T, H, W = _VORTEX
    return u, v, dict(dt=0.05, dx=2.0 / (W - 1), dy=1.0 / (H - 1))


def _random_field():
    # the field of tests/test_backend_parity.py::test_stream_parity_random_field
    rng = np.random.default_rng(11)
    u = rng.normal(0, 1, (5, 32, 40)).astype(np.float32)
    v = rng.normal(0, 1, (5, 32, 40)).astype(np.float32)
    return u, v


def _large_magnitude_field():
    # the verify-firing fixture of tests/test_backend_parity.py
    rng = np.random.default_rng(3)
    T, H, W = 4, 16, 16
    u = (1.0e8 + rng.normal(0, 100.0, (T, H, W))).astype(np.float32)
    v = (1.0e8 + rng.normal(0, 100.0, (T, H, W))).astype(np.float32)
    return u, v


def _cases():
    u, v, meta = _vortex()
    cases = {f"vortex-{p}": (u, v, dict(eb=1e-3, predictor=p, **meta))
             for p in ("lorenzo", "sl", "mop")}
    # a MoP case whose blockmap mixes both predictors
    u, v = synthetic.vortex_street(T=6, H=48, W=64)
    cases["vortex48-mop"] = (u, v, dict(eb=1e-2, dt=0.05, dx=2.0 / 63,
                                        dy=1.0 / 47))
    # non-default MoP blocks: 8 tiles both edges, 13 leaves partial
    # blocks on both
    for block in (8, 13):
        cases[f"vortex48-mop-b{block}"] = (u, v, dict(
            eb=1e-2, block=block, dt=0.05, dx=2.0 / 63, dy=1.0 / 47))
    cases["random-mop"] = _random_field() + (dict(eb=1e-2, predictor="mop"),)
    cases["verify-fixture"] = _large_magnitude_field() + (
        dict(eb=6.0, mode="abs", predictor="mop"),)
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def runs():
    """name -> (u, v, ref blob, ref stats, port blob, port stats)."""
    out = {}
    for name, (u, v, kw) in CASES.items():
        rb, rs = core.compress(u, v, core.CompressionConfig(backend="numpy",
                                                            **kw))
        pb, ps = repro_torch.compress(u, v, repro_torch.CompressionConfig(**kw),
                                      device="cpu")
        out[name] = (u, v, rb, rs, pb, ps)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_container_byte_equal(runs, name):
    u, v, rb, rs, pb, ps = runs[name]
    assert pb == rb
    assert ps["verify_rounds"] == rs["verify_rounds"]
    assert ps["verify_bad_counts"] == rs["verify_bad_counts"]
    header, _ = encode.unpack(pb)
    assert header["sl_backend"] == "numpy" and header["version"] == 2
    if name == "verify-fixture":
        assert ps["verify_rounds"] >= 1 and ps["verify_bad_counts"][0] > 0
    if name.startswith("vortex48-mop") or name == "random-mop":
        assert 0 < ps["sl_block_frac"] < 1


@pytest.mark.parametrize("name", list(CASES))
def test_cross_decode_bitwise(runs, name):
    u, v, rb, rs, pb, ps = runs[name]
    ref_of_port = core.decompress(pb)
    port_of_ref = repro_torch.decompress(rb, device="cpu")
    port_of_port = repro_torch.decompress(pb, device="cpu")
    for a, b, c in zip(ref_of_port, port_of_ref, port_of_port):
        assert a.dtype == np.float32 and np.array_equal(a, b)
        assert np.array_equal(a, c)
    ur, vr = port_of_port
    assert metrics.max_abs_error(u, v, ur, vr) <= ps["eb_abs"]
    fc = trajectory.false_cases(u, v, ur, vr, ps["scale"], device="cpu")
    assert fc["FC_t"] == 0 and fc["FC_s"] == 0


def test_xla_stepper_container_decodes():
    """A reference container written with the xla f64 stepper (the
    default off-TPU backend) decodes in the port with its own f64
    stepper, bitwise, at the displacements of a real field."""
    u, v, meta = _vortex()
    rb, _ = core.compress(u, v, core.CompressionConfig(
        eb=1e-3, predictor="sl", backend="xla", **meta))
    assert r_encode.unpack(rb)[0]["sl_backend"] == "xla"
    for a, b in zip(core.decompress(rb),
                    repro_torch.decompress(rb, device="cpu")):
        assert np.array_equal(a, b)


def test_adaptive_v3_container_decodes():
    """The reference's adaptive (v3) monolithic container shares the
    uniform decode path; the port decodes it bitwise."""
    from repro.core import ebpolicy as r_ebpolicy

    u, v, meta = _vortex()
    pol = r_ebpolicy.TilePolicy.make(3, 16, 16, 1e-3, {(0, 0, 0): 1e-2})
    rb, _ = core.compress(u, v, core.CompressionConfig(
        eb=1e-3, backend="numpy", eb_policy=pol,
        n_levels=r_ebpolicy.levels_for(pol), **meta))
    assert r_encode.unpack(rb)[0]["version"] == 3
    for a, b in zip(core.decompress(rb),
                    repro_torch.decompress(rb, device="cpu")):
        assert np.array_equal(a, b)


def test_golden_v2_decodes_bitwise():
    data = os.path.join(os.path.dirname(__file__), "data")
    with open(os.path.join(data, "golden_v2_mop.cptz"), "rb") as f:
        blob = f.read()
    exp = np.load(os.path.join(data, "golden_v2_expected.npz"))
    ur, vr = repro_torch.decompress(blob, device="cpu")
    assert np.array_equal(ur, exp["ur"]) and np.array_equal(vr, exp["vr"])
    fc = trajectory.false_cases(exp["u"], exp["v"], ur, vr,
                                float(exp["scale"]), device="cpu")
    assert fc["FC_t"] == 0 and fc["FC_s"] == 0


def test_metrics_match_reference():
    from repro.core import metrics as r_metrics

    u, v = _random_field()
    pb, ps = repro_torch.compress(u, v, repro_torch.CompressionConfig(eb=1e-2),
                                  device="cpu")
    ur, vr = repro_torch.decompress(pb, device="cpu")
    want = r_metrics.evaluate(u, v, ur, vr, ps["scale"], ps["orig_bytes"],
                              ps["comp_bytes"], with_tracks=False)
    got = metrics.evaluate(u, v, ur, vr, ps["scale"], ps["orig_bytes"],
                           ps["comp_bytes"], with_tracks=False, device="cpu")
    assert got == want


def test_config_fields_and_defaults_match():
    ref = {f.name: f.default for f in dataclasses.fields(core.CompressionConfig)}
    port = {f.name: f.default
            for f in dataclasses.fields(repro_torch.CompressionConfig)}
    assert port == ref
