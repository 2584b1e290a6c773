"""The legacy (seed) binding in the port (CPU), against the JAX package:
``CompressionConfig(fused=False)`` and ``REPRO_FUSED=0`` write the
reference's ``"pipeline": "legacy"`` container (no ``sl_backend``: the
"xla" stepper on every plane height, every face re-checked in each verify
round) byte for byte, with the same verify accounting, and each package
decodes the other's container bitwise.  ``compress_tiled`` and
``compress_stream`` ignore ``fused`` in both packages.

This file holds the cases at H = 32 (the vortex street with noise of
tests/test_torch_sl_containers.py, n_max 8), the environment switch, the
tiled and streamed entries and the "sl" golden container;
tests/test_torch_legacy_h30.py runs the checks below at H = 30 (n_max
32, where the f64 steppers part), on the field whose verify rounds fire
and under an adaptive policy (two files, so that two workers can run
them).

The golden containers under tests/data, ``golden_legacy_sl.cptl`` (host
codec, zlib) and ``golden_legacy_mop.cpth`` (device codec, H = 30), are
the reference's legacy containers of a case of each file, beside the
reference's decode; a test regenerates each with the reference (reusing
that case's compiles) and asserts the files are unchanged, so
chip_smoke.py can hold the card against the reference without importing
it.

    PYTHONPATH=src python tests/test_torch_legacy.py

rewrites both golden files.
"""
import pytest

pytest.importorskip("torch")

from pathlib import Path

import numpy as np

import repro.core as core
from repro.core import encode as r_encode
from repro.core import tiling as JT
import repro_torch
from repro_torch.core import encode

import test_torch_sl_containers as SL

DATA = Path(__file__).resolve().parent / "data"
SHAPE = (6, 32, 40)


def legacy_kw(shape, **kw):
    """The sl_containers cases' config (dt 40, n_max by plane height)."""
    return dict(eb=1e-2, dt=40.0, n_max=SL.SHAPES[shape], **kw)


def check_legacy(u, v, kw, r_kw=None, ref=None):
    """The port's ``fused=False`` container is the reference's, with its
    verify accounting; the port decodes it as the reference does (the
    bytes are equal, so each package decodes the other's).  ``r_kw``
    replaces ``kw`` on the reference's side (its own policy object);
    ``ref`` is the reference's (blob, stats) when already computed.
    Returns (blob, reference stats)."""
    rb, rs = ref or core.compress(u, v, core.CompressionConfig(
        fused=False, **(kw if r_kw is None else r_kw)))
    header = encode.unpack(rb)[0]
    assert header["pipeline"] == "legacy" and "sl_backend" not in header
    pb, ps = repro_torch.compress(
        u, v, repro_torch.CompressionConfig(fused=False, **kw), device="cpu")
    assert pb == rb
    for key in ("pipeline", "verify_rounds", "verify_bad_counts"):
        assert ps[key] == rs[key], key
    assert SL._same(repro_torch.decompress(rb, device="cpu"),
                    core.decompress(rb))
    return rb, rs


@pytest.fixture(scope="module")
def sl_case():
    """(u, v, config, the reference's (blob, stats)) of the "sl" case: one
    reference compress for the tests that share it (its eager SL encode
    traces anew on every call)."""
    u, v = SL._field(SHAPE)
    kw = legacy_kw(SHAPE, predictor="sl")
    return u, v, kw, core.compress(u, v, core.CompressionConfig(
        fused=False, **kw))


@pytest.mark.parametrize("predictor", ["sl", "lorenzo"])
def test_legacy_bytes_and_cross_decode(sl_case, predictor):
    u, v, kw, ref = sl_case
    if predictor == "sl":
        check_legacy(u, v, kw, ref=ref)
    else:
        check_legacy(u, v, legacy_kw(SHAPE, predictor=predictor))


def test_repro_fused_0_is_fused_false(monkeypatch, sl_case):
    """``REPRO_FUSED=0`` with ``fused=None`` writes the reference's legacy
    bytes; ``fused=True`` wins over it."""
    u, v, kw, (want, _) = sl_case
    fused, _ = repro_torch.compress(
        u, v, repro_torch.CompressionConfig(**kw), device="cpu")
    monkeypatch.setenv("REPRO_FUSED", "0")
    got, stats = repro_torch.compress(
        u, v, repro_torch.CompressionConfig(**kw), device="cpu")
    assert got == want and stats["pipeline"] == "legacy"
    assert repro_torch.compress(u, v, repro_torch.CompressionConfig(
        fused=True, **kw), device="cpu")[0] == fused != want


def test_tiled_and_stream_ignore_fused(monkeypatch):
    """``compress_tiled`` and ``compress_stream`` with ``fused=False``
    (and under ``REPRO_FUSED=0``) write the reference's bytes: its
    fused units, one tile and two windows, the "xla" stepper."""
    u, v = SL._field(SHAPE)
    kw = legacy_kw(SHAPE, predictor="mop", backend="xla", fused=False)
    vr = (float(min(u.min(), v.min())), float(max(u.max(), v.max())))
    want, _ = core.compress_tiled(u, v, core.CompressionConfig(**kw),
                                  JT.TileGrid(32, 40, 3))
    assert core.compress_stream(zip(u, v), core.CompressionConfig(**kw),
                                JT.TileGrid(32, 40, 3),
                                value_range=vr)[0] == want
    grid = repro_torch.TileGrid(32, 40, 3)
    cfg = repro_torch.CompressionConfig(**kw)
    assert repro_torch.compress_tiled(u, v, cfg, grid, device="cpu")[0] \
        == want
    assert repro_torch.compress_stream(zip(u, v), cfg, grid, value_range=vr,
                                       device="cpu")[0] == want
    monkeypatch.setenv("REPRO_FUSED", "0")
    cfg = repro_torch.CompressionConfig(
        **dict(kw, fused=None), tiling=grid)
    assert repro_torch.compress(u, v, cfg, device="cpu")[0] == want


# ----------------------------------------------------------------------
# golden containers
# ----------------------------------------------------------------------

# name -> (field shape, config of a case here or in the H = 30 file)
GOLDEN = {"sl": (SHAPE, dict(predictor="sl")),
          "mop": ((6, 30, 40), dict(predictor="mop", codec="device"))}


def reference_golden(name):
    """(container, (ur, vr)) as the reference writes and decodes it."""
    shape, kw = GOLDEN[name]
    u, v = SL._field(shape)
    with SL._zlib_codec():
        blob, _ = core.compress(u, v, core.CompressionConfig(
            fused=False, **legacy_kw(shape, **kw)))
        return blob, core.decompress(blob)


def golden_paths(name):
    ext = "cpth" if GOLDEN[name][1].get("codec") == "device" else "cptl"
    return (DATA / f"golden_legacy_{name}.{ext}",
            DATA / f"golden_legacy_{name}_decode.npz")


def write_goldens():
    for name in GOLDEN:
        blob, (ur, vr) = reference_golden(name)
        blob_path, npz_path = golden_paths(name)
        blob_path.write_bytes(blob)
        np.savez_compressed(npz_path, ur=ur, vr=vr)


def check_golden_is_the_references(name):
    blob, dec = reference_golden(name)
    blob_path, npz_path = golden_paths(name)
    assert blob_path.read_bytes() == blob
    stored = np.load(npz_path)
    assert SL._same((stored["ur"], stored["vr"]), dec)


def check_golden_decodes_bitwise(name):
    """The port decodes the golden legacy container to the reference's
    stored decode with every ``backend=`` (a legacy container ignores
    it)."""
    blob_path, npz_path = golden_paths(name)
    blob = blob_path.read_bytes()
    stored = np.load(npz_path)
    want = (stored["ur"], stored["vr"])
    header = r_encode.unpack(blob)[0]
    assert header["pipeline"] == "legacy" and "sl_backend" not in header
    for backend in (None, "numpy", "xla", "pallas"):
        assert SL._same(repro_torch.decompress(blob, backend, device="cpu"),
                        want), backend


def test_golden_container_is_the_references():
    check_golden_is_the_references("sl")


def test_golden_container_decodes_bitwise():
    check_golden_decodes_bitwise("sl")


if __name__ == "__main__":
    write_goldens()
