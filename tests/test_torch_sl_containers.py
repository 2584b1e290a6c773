"""Containers of the JAX package's "pallas" and "xla" SL steppers in the
port (CPU), at a plane height that is a multiple of the Pallas kernel's
8-row tile (H = 32: "pallas" runs its f32 body); the same checks at one
that is not (H = 30: "pallas" runs the f64 "xla" path) are in
tests/test_torch_sl_containers_h30.py, which imports this file's
checks (two files, so that two workers can run them).

For each backend, on a vortex street with noise, with predictor "sl"
and "mop" and both codecs: the port decodes
the reference's container bitwise and writes the same bytes with the
same backend (so the reference's decode of the port's container is its
decode of its own).  Each field is non-vacuous: its "pallas" residuals
differ from its "numpy" ones.

One tiled container (the two-window grid of tests/test_torch_nonfinite.py
at a 24-row tile, so every unit steps the f32 body): the reference's
bytes, decoded bitwise both ways.

The golden containers under tests/data are the "pallas" container of a
case here and the "xla" one of a case of the H = 30 file (host codec,
"sl"), whose substeps clamp,
written by the reference with the zlib codec (the card's machine has no
zstandard) beside the reference's decode; a test regenerates them with
the reference (reusing those cases' compiles in the same process) and
asserts the files are unchanged, so chip_smoke.py can hold the card
against the reference without importing it.  The "xla" one is at the
displacements where the f64 steppers diverge (ROADMAP Queue 3 item 2: a
decode with the numpy stepper, which the port ran on such containers
before, gives other values).

    PYTHONPATH=src python tests/test_torch_sl_containers.py

rewrites both golden files.
"""
import pytest

pytest.importorskip("torch")

import contextlib
from pathlib import Path

import numpy as np

import repro.core as core
from repro.core import encode as r_encode
from repro.core import tiling as JT
from repro.data import synthetic
import repro_torch
from repro_torch.core import encode

DATA = Path(__file__).resolve().parent / "data"

# (T, H, W): H % 8 == 0 and != 0; n_max 32 at H = 30, where the f64
# steppers need the longer substep runs to part
SHAPES = {(6, 32, 40): 8, (6, 30, 40): 32}


def _field(shape):
    T, H, W = shape
    u, v = synthetic.vortex_street(T=T, H=H, W=W)
    rng = np.random.default_rng(H)
    return tuple((np.asarray(a) + 2.0 * rng.standard_normal(shape))
                 .astype(np.float32) for a in (u, v))


def _cfg(shape, **kw):
    return dict(eb=1e-2, dt=40.0, n_max=SHAPES[shape], **kw)


def _residuals(blob, shape):
    _, sections = encode.unpack(blob)
    return encode.parse_field_sections(sections, shape)[:2]


def _same(a, b):
    return all(np.array_equal(x.view(np.uint32), y.view(np.uint32))
               for x, y in zip(a, b))


def check_container(shape, backend, predictor, codec):
    """The port decodes the reference's container bitwise and writes its
    bytes."""
    u, v = _field(shape)
    kw = _cfg(shape, predictor=predictor, codec=codec, backend=backend)
    rb, rs = core.compress(u, v, core.CompressionConfig(**kw))
    assert encode.unpack(rb)[0]["sl_backend"] == backend
    assert _same(repro_torch.decompress(rb, device="cpu"), core.decompress(rb))
    pb, ps = repro_torch.compress(u, v, repro_torch.CompressionConfig(**kw),
                                  device="cpu")
    assert pb == rb
    assert ps["verify_bad_counts"] == rs["verify_bad_counts"]


def check_non_vacuous(shape):
    """The "pallas" stepper's residuals (f32 at H = 32, the f64 "xla"
    path at H = 30) are not the "numpy" stepper's, with either
    predictor."""
    u, v = _field(shape)
    for predictor in ("sl", "mop"):
        blobs = {be: repro_torch.compress(u, v, repro_torch.CompressionConfig(
            **_cfg(shape, predictor=predictor, backend=be)), device="cpu")[0]
            for be in ("numpy", "pallas")}
        got = _residuals(blobs["pallas"], shape)
        base = _residuals(blobs["numpy"], shape)
        assert any((a != b).any() for a, b in zip(got, base)), predictor


@pytest.mark.parametrize("codec", ["host", "device"])
@pytest.mark.parametrize("predictor", ["sl", "mop"])
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_reference_container_decodes_and_bytes_equal(backend, predictor,
                                                     codec):
    check_container((6, 32, 40), backend, predictor, codec)


def test_fields_are_non_vacuous():
    check_non_vacuous((6, 32, 40))


# ----------------------------------------------------------------------
# a tiled container
# ----------------------------------------------------------------------

def test_tiled_pallas_container(monkeypatch):
    """compress_tiled with backend="pallas" (9x24x27 field, one 24x27
    tile, two windows: every unit steps the f32 body): the reference's
    bytes, and each package decodes the other's container bitwise.
    Non-vacuous: on the units' planes the numpy stepper predicts other
    integers."""
    from repro_torch.core import backend as T_backend

    shape = (9, 24, 27)
    u, v = synthetic.vortex_street(T=9, H=24, W=27)
    rng = np.random.default_rng(0)
    u, v = ((np.asarray(a) + rng.standard_normal(shape)).astype(np.float32)
            for a in (u, v))
    kw = dict(eb=1e-2, dt=20.0, n_max=8, backend="pallas",
              track_index=False)
    rb, _ = core.compress_tiled(u, v, core.CompressionConfig(**kw),
                                JT.TileGrid(24, 27, 5))
    calls = []

    def recorder(step):
        def recorded(*args):
            calls.append((step, args))
            return step(*args)
        return recorded

    for name in ("sl_predictions", "sl_predictions_units"):
        monkeypatch.setattr(T_backend, name,
                            recorder(getattr(T_backend, name)))
    pb, _ = repro_torch.compress_tiled(
        u, v, repro_torch.CompressionConfig(**kw),
        repro_torch.TileGrid(24, 27, 5), device="cpu")
    assert pb == rb
    assert _same(repro_torch.decompress(rb, device="cpu"), core.decompress(rb))
    assert _same(core.decompress(pb), repro_torch.decompress(pb, device="cpu"))
    assert calls and all(a[-1] == "pallas" for _, a in calls)
    assert any(any((x != y).any() for x, y in zip(step(*a),
                                                   step(*a[:-1], "numpy")))
               for step, a in calls)


# ----------------------------------------------------------------------
# golden containers
# ----------------------------------------------------------------------

# name -> field shape: the host-codec "sl" cases (whose substeps clamp:
# displacements up to about 270 d_max); "pallas" at H = 32 (f32, n_max
# 8), "xla" at H = 30 (n_max 32)
GOLDEN = {"pallas": (6, 32, 40), "xla": (6, 30, 40)}


@contextlib.contextmanager
def _zlib_codec():
    saved = r_encode.zstandard
    r_encode.zstandard = None
    try:
        yield
    finally:
        r_encode.zstandard = saved


def reference_golden(name):
    """(container, (ur, vr)) as the reference writes and decodes it."""
    shape = GOLDEN[name]
    u, v = _field(shape)
    kw = _cfg(shape, predictor="sl", backend=name)
    with _zlib_codec():
        blob, _ = core.compress(u, v, core.CompressionConfig(**kw))
        return blob, core.decompress(blob)


def golden_paths(name):
    return (DATA / f"golden_sl_{name}.cptl",
            DATA / f"golden_sl_{name}_decode.npz")


def write_goldens():
    for name in GOLDEN:
        blob, (ur, vr) = reference_golden(name)
        blob_path, npz_path = golden_paths(name)
        blob_path.write_bytes(blob)
        np.savez_compressed(npz_path, ur=ur, vr=vr)


def check_golden_is_the_references(name):
    blob, dec = reference_golden(name)
    blob_path, npz_path = golden_paths(name)
    assert blob[:5] == r_encode.MAGIC_ZLIB
    assert blob_path.read_bytes() == blob
    stored = np.load(npz_path)
    assert _same((stored["ur"], stored["vr"]), dec)


def check_golden_decodes_bitwise(name):
    """The port decodes the golden container to the reference's stored
    decode.  The same residuals replayed with the numpy stepper (what
    the port did with "xla" containers before) give other values."""
    blob_path, npz_path = golden_paths(name)
    blob = blob_path.read_bytes()
    stored = np.load(npz_path)
    want = (stored["ur"], stored["vr"])
    header, sections = r_encode.unpack(blob)
    assert header["sl_backend"] == name
    assert _same(repro_torch.decompress(blob, device="cpu"), want)
    header = dict(header)
    header.pop("codec")
    doctored = r_encode.pack(dict(header, sl_backend="numpy"),
                             {k: np.array(a) for k, a in sections.items()})
    assert not _same(repro_torch.decompress(doctored, device="cpu"), want)


def test_golden_container_is_the_references():
    check_golden_is_the_references("pallas")


def test_golden_container_decodes_bitwise():
    check_golden_decodes_bitwise("pallas")


if __name__ == "__main__":
    write_goldens()
