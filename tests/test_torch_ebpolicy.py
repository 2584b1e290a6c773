"""Adaptive base error bounds in the port against the JAX package (CPU).

A ``TilePolicy`` compress with ``device="cpu"`` must write the bytes of
``repro.core.compress(..., backend="numpy")`` with the same policy (the
version 3 container with the policy in its header), with either codec;
containers cross-decode bitwise both ways, FC_t = FC_s = 0, and every
vertex stays within its own base bound.  The uniform spellings keep the
pre-policy (version 2) bytes.  Mirrors the monolithic cases of
tests/test_ebpolicy.py.
"""
import pytest

pytest.importorskip("torch")

import msgpack
import numpy as np

import repro.core as core
from repro.core import ebpolicy as r_ebpolicy
import repro_torch
from repro_torch.core import (_msgpack, compressor, ebpolicy, encode,
                              pipeline, trajectory)

T, H, W = 7, 16, 20
VALUES = {(0, 0, 0): 5e-3, (1, 1, 1): 1e-2, (2, 2, 1): 2e-3}
# the policy of tests/test_ebpolicy.py
POL = ebpolicy.TilePolicy.make(2, 6, 8, default=5e-2, values=VALUES)
R_POL = r_ebpolicy.TilePolicy.make(2, 6, 8, default=5e-2, values=VALUES)

# the verify-firing fixture of tests/test_backend_parity.py under a
# policy: some vertices break their own (tighter) bound in round 0
BIG_POL = ebpolicy.TilePolicy.make(2, 8, 8, default=6.0,
                                   values={(0, 0, 0): 3.0, (1, 1, 1): 1.5})


@pytest.fixture(scope="module")
def field():
    rng = np.random.default_rng(7)
    u = rng.normal(size=(T, H, W)).astype(np.float32)
    v = rng.normal(size=(T, H, W)).astype(np.float32)
    u[:, :, 9] *= 0.05   # near-zero bands so crossings exist
    v[:, 6, :] *= 0.05
    return u, v


def _big_field():
    rng = np.random.default_rng(3)
    u = (1.0e8 + rng.normal(0, 100.0, (4, 16, 16))).astype(np.float32)
    v = (1.0e8 + rng.normal(0, 100.0, (4, 16, 16))).astype(np.float32)
    return u, v


def _kw(pol, **kw):
    kw.setdefault("eb", 5e-2)
    kw.setdefault("mode", "abs")
    return dict(eb_policy=pol, n_levels=ebpolicy.levels_for(pol), **kw)


CASES = {
    "host": (POL, dict()),
    "device": (POL, dict(codec="device")),
    "rel": (POL, dict(mode="rel")),
    "verify-fixture": (BIG_POL, dict(eb=6.0)),
}


@pytest.fixture(scope="module")
def runs(field):
    """name -> (u, v, ref blob, ref stats, port blob, port stats)."""
    out = {}
    for name, (pol, kw) in CASES.items():
        u, v = _big_field() if name == "verify-fixture" else field
        r_pol = r_ebpolicy.policy_from_spec(pol.spec())
        rb, rs = core.compress(u, v, core.CompressionConfig(
            backend="numpy", **_kw(r_pol, **kw)))
        pb, ps = repro_torch.compress(
            u, v, repro_torch.CompressionConfig(**_kw(pol, **kw)),
            device="cpu")
        out[name] = (u, v, rb, rs, pb, ps)
    return out


# ------------------------------------------------- uniform byte-identity

def test_uniform_policy_byte_identical_monolithic(field):
    u, v = field
    blobs = {repro_torch.compress(u, v, repro_torch.CompressionConfig(
        eb=5e-2, mode="abs", eb_policy=p), device="cpu")[0]
        for p in (None, "uniform", ebpolicy.UniformPolicy(),
                  r_ebpolicy.UniformPolicy())}
    assert len(blobs) == 1
    blob = blobs.pop()
    header, _ = encode.unpack(blob)
    assert header["version"] == pipeline.FORMAT_VERSION
    assert "eb_policy" not in header
    rb, _ = core.compress(u, v, core.CompressionConfig(
        eb=5e-2, mode="abs", backend="numpy"))
    assert blob == rb


# -------------------------------------------- adaptive == the reference

@pytest.mark.parametrize("name", list(CASES))
def test_adaptive_container_byte_equal(runs, name):
    u, v, rb, rs, pb, ps = runs[name]
    assert pb == rb
    assert ps["verify_bad_counts"] == rs["verify_bad_counts"]
    assert ps["eb_abs"] == rs["eb_abs"] and ps["tau"] == rs["tau"]
    if name == "verify-fixture":
        assert ps["verify_rounds"] >= 1 and ps["verify_bad_counts"][0] > 0
    if name == "device":
        assert pb[:5] == encode.MAGIC_HUF


@pytest.mark.parametrize("name", list(CASES))
def test_adaptive_cross_decode_and_guarantees(runs, name):
    u, v, rb, rs, pb, ps = runs[name]
    ref_of_port = core.decompress(pb)
    port_of_ref = repro_torch.decompress(rb, device="cpu")
    for a, b in zip(ref_of_port, port_of_ref):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    ur, vr = port_of_ref
    fc = trajectory.false_cases(u, v, ur, vr, ps["scale"], device="cpu")
    assert fc["FC_t"] == 0 and fc["FC_s"] == 0
    pol, kw = CASES[name]
    factor = compressor._eb_factor(
        u, v, repro_torch.CompressionConfig(**_kw(pol, **kw)))
    bound = ebpolicy.field_bounds(pol, u.shape, factor)
    err = np.maximum(np.abs(ur.astype(np.float64) - u),
                     np.abs(vr.astype(np.float64) - v))
    assert (err <= bound).all()
    # the policy is tighter than the plan's scalar somewhere, and used
    assert bound.min() < ps["eb_abs"]


def test_reference_policy_object_accepted(field, runs):
    """The reference's TilePolicy is rebuilt from its spec()."""
    u, v = field
    pb, _ = repro_torch.compress(
        u, v, repro_torch.CompressionConfig(**_kw(R_POL)), device="cpu")
    assert pb == runs["host"][4]
    assert ebpolicy.normalize(R_POL) == POL


@pytest.mark.parametrize("shape,factor,scale", [
    ((7, 16, 20), 1.0, 2.0 ** 20), ((5, 13, 29), 3.7, 1234.5),
    ((3, 6, 8), 0.25, 2.0 ** 30)])
def test_field_bounds_and_caps_equal_reference(shape, factor, scale):
    assert np.array_equal(ebpolicy.field_bounds(POL, shape, factor),
                          r_ebpolicy.field_bounds(R_POL, shape, factor))
    assert np.array_equal(
        ebpolicy.field_caps(POL, shape, factor, scale),
        r_ebpolicy.field_caps(R_POL, shape, factor, scale))


# ------------------------------------------------ self-describing format

def test_adaptive_container_versions_and_policy_header(runs):
    for name in CASES:
        header, _ = encode.unpack(runs[name][4])
        assert header["version"] == pipeline.FORMAT_VERSION_ADAPTIVE
        assert ebpolicy.policy_from_spec(header["eb_policy"]) \
            == CASES[name][0]
        assert list(header)[:5] == ["version", "pipeline", "predictor",
                                    "eb_policy", "sl_backend"]


def test_policy_spec_roundtrip_and_validation():
    spec = POL.spec()
    assert ebpolicy.policy_from_spec(spec) == POL
    # the port's msgpack writes the spec as msgpack-python does, and
    # reads it back in the list form
    assert _msgpack.packb(spec) == msgpack.packb(spec, use_bin_type=True)
    listy = _msgpack.unpackb(_msgpack.packb(spec))
    assert isinstance(listy, list)
    assert ebpolicy.policy_from_spec(listy) == POL
    assert ebpolicy.normalize(listy) == POL
    with pytest.raises(ValueError):
        ebpolicy.TilePolicy.make(0, 6, 8, default=1e-2)
    with pytest.raises(ValueError):
        ebpolicy.TilePolicy.make(2, 6, 8, default=-1.0)
    with pytest.raises(ValueError):
        ebpolicy.TilePolicy.make(2, 6, 8, default=1e-2,
                                 values={(0, 0): 1e-3})
    with pytest.raises(ValueError):
        ebpolicy.policy_from_spec(("flat", 1))
    with pytest.raises(TypeError):
        ebpolicy.normalize(object())


def test_levels_for_covers_policy_span():
    pol = ebpolicy.TilePolicy.make(1, 8, 8, default=0.64,
                                   values={(0, 0, 0): 0.01})
    # span 64 -> ladder needs ceil(log2(64)) + 1 = 7 rungs
    assert ebpolicy.levels_for(pol) == 7
    assert ebpolicy.levels_for(pol, n_levels=9) == 9
    assert ebpolicy.min_bound(pol) == 0.01
    assert ebpolicy.max_bound(pol) == 0.64
    assert ebpolicy.levels_for(POL) == r_ebpolicy.levels_for(R_POL)
