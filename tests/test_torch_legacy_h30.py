"""The checks of tests/test_torch_legacy.py at H = 30 (n_max 32, where
the f64 steppers part), on the field whose verify rounds fire (the only
case that reaches the legacy binding's full verify, with a uniform bound
and under an adaptive policy), and the device-codec golden container
(CPU).  The "numpy" stepper decodes that clamped container wrongly: the
fault the port had before it decoded legacy containers with the "xla"
stepper.
"""
import pytest

pytest.importorskip("torch")

import numpy as np

from repro.core import ebpolicy as r_ebpolicy
from repro.core import encode as r_encode
import repro_torch
from repro_torch.core import ebpolicy

import test_torch_legacy as L
import test_torch_sl_containers as SL

SHAPE = (6, 30, 40)

# the verify-firing fixture of tests/test_backend_parity.py under a
# policy (tests/test_torch_ebpolicy.py): some vertices break their own
# bound in round 0
POLICY = dict(window_t=2, tile_h=8, tile_w=8, default=6.0,
              values={(0, 0, 0): 3.0, (1, 1, 1): 1.5})


def _large_magnitude_field():
    rng = np.random.default_rng(3)
    u = (1.0e8 + rng.normal(0, 100.0, (4, 16, 16))).astype(np.float32)
    v = (1.0e8 + rng.normal(0, 100.0, (4, 16, 16))).astype(np.float32)
    return u, v


def test_legacy_bytes_and_cross_decode():
    """"mop" with the device codec at H = 30, n_max 32."""
    u, v = SL._field(SHAPE)
    L.check_legacy(u, v, L.legacy_kw(SHAPE, predictor="mop",
                                     codec="device"))


def test_full_verify_rounds_fire():
    u, v = _large_magnitude_field()
    _, stats = L.check_legacy(u, v, dict(eb=6.0, mode="abs"))
    assert stats["verify_rounds"] >= 1


def test_adaptive_policy_full_verify():
    u, v = _large_magnitude_field()
    pol = ebpolicy.TilePolicy.make(**POLICY)
    r_pol = r_ebpolicy.TilePolicy.make(**POLICY)
    kw = dict(eb=6.0, mode="abs", n_levels=ebpolicy.levels_for(pol))
    blob, stats = L.check_legacy(u, v, dict(kw, eb_policy=pol),
                                 dict(kw, eb_policy=r_pol))
    assert stats["verify_rounds"] >= 1
    header = r_encode.unpack(blob)[0]
    assert header["version"] == 3 and "eb_policy" in header


def test_golden_container_is_the_references():
    assert L.GOLDEN["mop"][0] == SHAPE
    L.check_golden_is_the_references("mop")


def test_golden_container_decodes_bitwise():
    L.check_golden_decodes_bitwise("mop")


def test_numpy_stepper_decodes_the_legacy_container_wrongly():
    """The golden legacy container's residuals relabelled as a fused
    container of each stepper: "xla" gives the reference's decode, the
    "numpy" stepper (what a decode that ignored the legacy tag would
    run, the port's default) other values."""
    blob_path, npz_path = L.golden_paths("mop")
    blob = blob_path.read_bytes()
    stored = np.load(npz_path)
    want = (stored["ur"], stored["vr"])
    header, sections = r_encode.unpack(blob)
    header = dict(header, pipeline="fused")
    header.pop("codec")
    got = {tag: repro_torch.decompress(
        r_encode.pack(dict(header, sl_backend=tag), sections),
        device="cpu") for tag in ("xla", "numpy")}
    assert SL._same(got["xla"], want)
    assert not SL._same(got["numpy"], want)
