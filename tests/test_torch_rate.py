"""Rate-targeted compression of the port against the JAX package (CPU).

``repro_torch.compress(u, v, cfg, target_ratio=r, device="cpu")`` must
write the bytes and the ``stats["rate_target"]`` record of
``repro.core.compress(..., target_ratio=r)`` with ``backend="numpy"``:
when the uniform run already meets the target, and when the relax
ladder runs (the target above the uniform ratio).  Every vertex of the
result stays within its own policy bound and FC_t = FC_s = 0.  Mirrors
the target-ratio cases of tests/test_ebpolicy.py and
tests/adaptive_smoke.py.
"""
import pytest

pytest.importorskip("torch")

import numpy as np

import repro.core as core
import repro_torch
from repro_torch.core import ebpolicy, encode, trajectory
from repro_torch.data import synthetic

KW = dict(eb=1e-3, mode="abs")


@pytest.fixture(scope="module")
def field():
    return synthetic.double_gyre(T=6, H=32, W=32)


@pytest.fixture(scope="module")
def uniform(field):
    u, v = field
    return core.compress(u, v, core.CompressionConfig(backend="numpy",
                                                      **KW))[1]["ratio"]


@pytest.fixture(scope="module", params=[0.5, 1.5])
def runs(request, field, uniform):
    """(target, reference (blob, stats), port (blob, stats))."""
    u, v = field
    target = uniform * request.param
    ref = core.compress(u, v, core.CompressionConfig(backend="numpy", **KW),
                        target_ratio=target)
    port = repro_torch.compress(u, v, repro_torch.CompressionConfig(**KW),
                                target_ratio=target, device="cpu")
    return target, ref, port


def test_bytes_and_record_equal_reference(runs):
    target, (rb, rs), (pb, ps) = runs
    assert pb == rb
    assert ps["rate_target"] == rs["rate_target"]
    assert ps["rate_target"]["target_ratio"] == target


def test_ladder_runs_above_the_uniform_ratio(runs, uniform):
    target, _, (pb, ps) = runs
    rec = ps["rate_target"]
    if target <= uniform:
        assert rec["uniform_sufficient"] and rec["relax"] == 1.0
        assert encode.unpack(pb)[0]["version"] == 2
        return
    assert not rec["uniform_sufficient"]
    assert len(rec["rungs_tried"]) >= 2 and rec["n_protected"] > 0
    assert rec["n_protected"] < rec["n_units"]
    assert encode.unpack(pb)[0]["version"] == 3


def test_every_vertex_within_its_policy_bound(runs, field):
    u, v = field
    _, _, (pb, ps) = runs
    ur, vr = repro_torch.decompress(pb, device="cpu")
    header = encode.unpack(pb)[0]
    if "eb_policy" in header:
        pol = ebpolicy.policy_from_spec(header["eb_policy"])
        bound = ebpolicy.field_bounds(pol, u.shape, 1.0)
    else:
        bound = ps["eb_abs"]
    err = np.maximum(np.abs(ur.astype(np.float64) - u),
                     np.abs(vr.astype(np.float64) - v))
    assert (err <= bound).all()
    fc = trajectory.false_cases(u, v, ur, vr, ps["scale"], device="cpu")
    assert fc["FC_t"] == 0 and fc["FC_s"] == 0


def test_explicit_policy_and_bad_target_refused(field):
    u, v = field
    pol = ebpolicy.TilePolicy.make(2, 8, 8, default=1e-2,
                                   values={(0, 0, 0): 1e-3})
    cfg = repro_torch.CompressionConfig(eb_policy=pol,
                                        n_levels=ebpolicy.levels_for(pol),
                                        **KW)
    with pytest.raises(ValueError, match="policy"):
        repro_torch.compress(u, v, cfg, target_ratio=2.0, device="cpu")
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError, match="target_ratio"):
            repro_torch.compress(u, v, repro_torch.CompressionConfig(**KW),
                                 target_ratio=bad, device="cpu")
