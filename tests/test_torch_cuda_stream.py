"""Streaming compression, crash recovery and track queries on the card.

The stream written on the card (serial and async engine, host and
device codec) equals the stream written on the CPU, and both equal
``compress_tiled``; a journal written by a crashed card run resumes on
the CPU to the same bytes; salvage, a degraded decode and
``decode_for_track`` on the card equal the CPU's.  These tests need a
CUDA device and nvcc; elsewhere they skip.  The file imports no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_stream.py
"""
import pytest

pytest.importorskip("torch")

import numpy as np
import torch

import repro_torch
from repro_torch import analysis
from repro_torch.core import encode, faults
from repro_torch.data import synthetic

pytestmark = pytest.mark.cuda

GRID = repro_torch.TileGrid(32, 48, 3)


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def field():
    u, v = synthetic.vortex_street(T=12, H=64, W=96)
    vr = (float(min(u.min(), v.min())), float(max(u.max(), v.max())))
    return u, v, list(zip(u, v)), vr


def _cfg(codec):
    return repro_torch.CompressionConfig(codec=codec, dt=0.05, dx=2.0 / 95,
                                         dy=1.0 / 63)


@pytest.mark.parametrize("codec", ["host", "device"])
def test_card_stream_equals_cpu_stream_on_both_engines(dev, field, codec):
    u, v, pairs, vr = field
    cpu, _ = repro_torch.compress_stream(iter(pairs), _cfg(codec), GRID,
                                         value_range=vr, device="cpu")
    tiled, _ = repro_torch.compress_tiled(u, v, _cfg(codec), GRID,
                                          device=dev)
    for async_engine in (False, True):
        card, st = repro_torch.compress_stream(
            iter(pairs), _cfg(codec), GRID, value_range=vr,
            async_engine=async_engine, device=dev)
        assert card == cpu == tiled
        assert st["async_engine"] is async_engine
        assert st["device"] == str(dev)


def test_card_journal_resumes_on_the_cpu(dev, field, tmp_path):
    u, v, pairs, vr = field
    p = tmp_path / "crash.cptt"
    with pytest.raises(faults.InjectedFault):
        repro_torch.compress_stream(
            lambda t0: iter(pairs[t0:]), _cfg("host"), GRID, value_range=vr,
            sink=str(p), async_engine=True, device=dev,
            faults=faults.FaultPlan().io_error("stream.compute", nth=11))
    _, st = repro_torch.compress_stream(
        lambda t0: iter(pairs[t0:]), _cfg("host"), GRID, value_range=vr,
        sink=str(p), resume=True, device="cpu")
    assert st["resumed_from"] > 0
    want, _ = repro_torch.compress_tiled(u, v, _cfg("host"), GRID,
                                         device="cpu")
    assert p.read_bytes() == want


def test_card_salvage_degraded_decode_and_track_query(dev, field):
    u, v, pairs, vr = field
    blob, _ = repro_torch.compress_stream(iter(pairs), _cfg("device"), GRID,
                                          value_range=vr, device=dev)
    units = encode.tiled_header(blob)["units"]
    last = max(units, key=lambda e: e["off"])
    salvaged, rep = encode.salvage_container(
        blob[: last["off"] + last["len"]])
    assert rep["units_recovered"] == len(units)
    full = repro_torch.decompress_tiled(blob, device=dev)
    su, sv = repro_torch.decompress_tiled(salvaged, device=dev)
    assert np.array_equal(su, full[0]) and np.array_equal(sv, full[1])
    entry = units[1]
    bad = bytearray(blob)
    bad[entry["off"] + entry["len"] // 2] ^= 0x20
    du, dv, drep = repro_torch.decompress_tiled(bytes(bad), device=dev,
                                                degraded=True)
    cu, cv, crep = repro_torch.decompress_tiled(bytes(bad), device="cpu",
                                                degraded=True)
    assert np.array_equal(du, cu) and np.array_equal(dv, cv)
    assert [m["key"] for m in drep.missing_units] == [tuple(entry["key"])]
    hole = drep.hole_mask((0,) + u.shape[:1] + (0,) + u.shape[1:2] + (0,)
                          + u.shape[2:])
    assert np.array_equal(du[~hole], full[0][~hole]) and not du[hole].any()
    analysis.configure_unit_cache(0)
    try:
        for k in range(len(analysis.track_summaries(blob))):
            a = analysis.decode_for_track(blob, k, device=dev)
            b = analysis.decode_for_track(blob, k, device="cpu")
            assert np.array_equal(a.track.nodes, b.track.nodes)
            assert np.array_equal(a.track.types, b.track.types)
    finally:
        analysis.configure_unit_cache(256)
