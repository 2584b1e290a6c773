"""The port's tiled containers where the verify rounds fire, and the
unit-batched stages over other predictors and blocks (CPU).

The large-magnitude field (base 1e8, eb = 6 abs) makes the pointwise
check fail in the first verify round, so the seam-agreed fixpoint runs
a second, incremental round over chunks of several units: the port
must still write the reference's bytes, with and without
``batch_units``, and decode as the monolithic pipeline does.  The
other cases hold the port to itself: a tiled decode equals the
monolithic decode and the unit-batched stages write the bytes of the
single-unit ones, for each predictor and a block that leaves partial
blocks.
"""
import pytest

pytest.importorskip("torch")

import numpy as np
import torch

import repro.core as core
from repro.core import tiling as r_tiling
import repro_torch
from repro_torch.core import encode, tiling, trajectory
from repro_torch.data import synthetic

# 4x4 tiles of 4x4 in 2 windows of 2 frames: per window 4 interior
# units share a signature, each side's 2 edge units another
GRID = (4, 4, 2)
KW = dict(eb=6.0, mode="abs")


def _large_magnitude_field():
    rng = np.random.default_rng(3)
    u = (1.0e8 + rng.normal(0, 100.0, (4, 16, 16))).astype(np.float32)
    v = (1.0e8 + rng.normal(0, 100.0, (4, 16, 16))).astype(np.float32)
    return u, v


@pytest.fixture(scope="module")
def big():
    u, v = _large_magnitude_field()
    ref, st = r_tiling.compress_tiled(
        u, v, core.CompressionConfig(backend="numpy", **KW),
        r_tiling.TileGrid(*GRID))
    return u, v, ref, st


@pytest.mark.parametrize("batch_units", [True, False])
def test_rounds_fire_and_bytes_equal_reference(big, batch_units):
    u, v, ref, ref_st = big
    blob, st = repro_torch.compress_tiled(
        u, v, repro_torch.CompressionConfig(batch_units=batch_units, **KW),
        repro_torch.TileGrid(*GRID), device="cpu")
    assert st["verify_rounds"] >= 1 and st["verify_bad_counts"][0] > 0
    assert st["verify_bad_counts"][-1] == 0
    assert st["verify_bad_counts"] == ref_st["verify_bad_counts"]
    assert blob == ref
    verify = st["chunks"]["verify"]
    if batch_units:
        # the incremental round runs in chunks too, several units each
        assert verify["multi"] > 10 and verify["sl_multi"] > 0
    else:
        assert verify["multi"] == 0


@pytest.mark.parametrize("k", [2, 3])
def test_rounds_fire_tiles_mesh_bytes_equal_reference(monkeypatch, big, k):
    """The incremental rounds' chunks dealt to k workers (the CPU listed
    k times as the tiles mesh): the forced sets merge on the caller into
    the reference's bytes and bad counts."""
    from repro_torch.parallel import sharding

    u, v, ref, ref_st = big
    monkeypatch.setattr(sharding, "tiles_devices",
                        lambda device: [torch.device("cpu")] * k)
    blob, st = repro_torch.compress_tiled(
        u, v, repro_torch.CompressionConfig(**KW),
        repro_torch.TileGrid(*GRID), device="cpu")
    assert st["verify_rounds"] >= 1
    assert st["verify_bad_counts"] == ref_st["verify_bad_counts"]
    assert blob == ref
    verify = st["chunks"]["units"]["verify"]
    assert len(verify) == k and min(verify) > 0


def test_rounds_fire_decode_equals_monolithic(big):
    u, v, ref, ref_st = big
    mono, st = repro_torch.compress(u, v, repro_torch.CompressionConfig(**KW),
                                    device="cpu")
    assert st["verify_rounds"] >= 1
    mu, mv = repro_torch.decompress(mono, device="cpu")
    tu, tv = repro_torch.decompress(ref, device="cpu")
    ru, rv = r_tiling.decompress_tiled(ref)
    assert np.array_equal(tu, mu) and np.array_equal(tv, mv)
    assert np.array_equal(tu, ru) and np.array_equal(tv, rv)
    assert np.abs(tu.astype(np.float64) - u).max() <= ref_st["eb_abs"]
    fc = trajectory.false_cases(u, v, tu, tv, ref_st["scale"],
                                device="cpu")
    assert fc["FC_t"] == 0 and fc["FC_s"] == 0


def test_sink_receives_the_same_bytes(big, tmp_path):
    u, v, ref, _ = big
    path = tmp_path / "big.cptt"
    with open(path, "wb") as f:
        blob, st = repro_torch.compress_tiled(
            u, v, repro_torch.CompressionConfig(**KW),
            repro_torch.TileGrid(*GRID), sink=f, device="cpu")
    assert blob is None and st["comp_bytes"] == len(ref)
    assert path.read_bytes() == ref
    assert encode.TRACK_INDEX_KEY in encode.tiled_header(ref)


def _vortex(T=8, H=32, W=48):
    u, v = synthetic.vortex_street(T=T, H=H, W=W)
    return u, v, dict(dt=0.05, dx=2.0 / (W - 1), dy=1.0 / (H - 1))


@pytest.mark.parametrize("predictor,block", [("mop", 16), ("mop", 5),
                                             ("sl", 13), ("lorenzo", 16)])
def test_unit_batches_write_single_unit_bytes(predictor, block):
    u, v, meta = _vortex()
    grid = repro_torch.TileGrid(12, 12, 3)
    blobs = []
    for batch_units in (True, False):
        cfg = repro_torch.CompressionConfig(
            eb=1e-3, predictor=predictor, block=block,
            batch_units=batch_units, batch_cap=3, **meta)
        blob, st = repro_torch.compress_tiled(u, v, cfg, grid, device="cpu")
        blobs.append(blob)
    assert blobs[0] == blobs[1]
    assert st["chunks"]["verify"]["single"] == st["n_units"] == 36
    mono, _ = repro_torch.compress(
        u, v, repro_torch.CompressionConfig(eb=1e-3, predictor=predictor,
                                            block=block, **meta),
        device="cpu")
    mu, mv = repro_torch.decompress(mono, device="cpu")
    tu, tv = repro_torch.decompress(blobs[0], device="cpu")
    assert np.array_equal(tu, mu) and np.array_equal(tv, mv)


def test_batch_cap_changes_no_byte():
    u, v, meta = _vortex(T=6, H=24, W=40)
    grid = repro_torch.TileGrid(6, 8, 3)
    out = {}
    for cap in (1, 2, 8):
        cfg = repro_torch.CompressionConfig(eb=1e-2, batch_cap=cap, **meta)
        out[cap] = repro_torch.compress_tiled(u, v, cfg, grid, device="cpu")
    assert out[1][0] == out[2][0] == out[8][0]
    assert out[1][1]["chunks"]["verify"]["multi"] == 0
    assert out[2][1]["chunks"]["verify"]["multi"] \
        > out[8][1]["chunks"]["verify"]["multi"] > 0
