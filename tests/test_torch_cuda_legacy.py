"""The legacy (seed) binding and the decode-side ``backend=`` on the card.

A ``fused=False`` compress on the card writes the CPU's bytes (the cases
of tests/test_torch_legacy*.py), launches no K1 and the "xla" K4 / K3
and K2's ``face_crossed`` only; the golden legacy containers of
tests/data (written by the JAX package) decode on the card to the
reference's stored decode whatever ``backend=`` says, and the golden
"xla" / "pallas" containers decode with each ``backend=`` the card runs
to the reference's stored decode with it; ``backend="numpy"`` (the plain
versions) is refused on the card.  These tests need a CUDA device and
nvcc; elsewhere they skip.  The file imports no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_legacy.py
"""
import pytest

pytest.importorskip("torch")

from pathlib import Path

import numpy as np
import torch

import repro_torch
from repro_torch.data import synthetic
from repro_torch.kernels.cptest import kernel as k2
from repro_torch.kernels.lorenzo import kernel as k1
from repro_torch.kernels.semilagrange import kernel as k3

pytestmark = pytest.mark.cuda

DATA = Path(__file__).resolve().parent / "data"
# (T, H, W) -> (n_max, predictor, codec): the legacy tests' cases
CASES = {(6, 32, 40): (8, "sl", "host"), (6, 30, 40): (32, "mop", "device")}


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _field(shape):
    T, H, W = shape
    u, v = synthetic.vortex_street(T=T, H=H, W=W)
    rng = np.random.default_rng(H)
    return tuple((np.asarray(a) + 2.0 * rng.standard_normal(shape))
                 .astype(np.float32) for a in (u, v))


def _same(a, b):
    return all(np.array_equal(x.view(np.uint32), y.view(np.uint32))
               for x, y in zip(a, b))


def _stored(name):
    d = np.load(DATA / name)
    return d["ur"], d["vr"]


@pytest.mark.parametrize("shape", list(CASES))
def test_legacy_card_bytes_equal_cpu(dev, shape):
    n_max, predictor, codec = CASES[shape]
    u, v = _field(shape)
    cfg = repro_torch.CompressionConfig(eb=1e-2, dt=40.0, n_max=n_max,
                                        predictor=predictor, codec=codec,
                                        fused=False)
    wrappers = (k1.lorenzo_residual, k3.sl_step_batched_xla,
                k3.sl_decode_xla, k2.face_crossed, k3.sl_step_batched,
                k3.sl_decode, k2.verify_faces)
    before = [w.launches for w in wrappers]
    blob, _ = repro_torch.compress(u, v, cfg, device=dev)
    n = [w.launches - b for w, b in zip(wrappers, before)]
    assert n[0] == 0 and min(n[1:4]) >= 1 and n[4:] == [0, 0, 0], n
    assert blob == repro_torch.compress(u, v, cfg, device="cpu")[0]
    assert _same(repro_torch.decompress(blob, device=dev),
                 repro_torch.decompress(blob, device="cpu"))


@pytest.mark.parametrize("name", ["golden_legacy_sl.cptl",
                                  "golden_legacy_mop.cpth"])
@pytest.mark.parametrize("backend", [None, "xla", "pallas"])
def test_golden_legacy_decodes_on_the_card(dev, name, backend):
    blob = (DATA / name).read_bytes()
    got = repro_torch.decompress(blob, backend, device=dev)
    assert _same(got, _stored(name.split(".")[0] + "_decode.npz"))


@pytest.mark.parametrize("tag", ["xla", "pallas"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_golden_sl_decodes_with_backend(dev, tag, backend):
    blob = (DATA / f"golden_sl_{tag}.cptl").read_bytes()
    got = repro_torch.decompress(blob, backend, device=dev)
    assert _same(got, _stored(f"golden_sl_{tag}_decode_{backend}.npz"))


def test_numpy_backend_refused_on_the_card(dev):
    blob = (DATA / "golden_sl_xla.cptl").read_bytes()
    with pytest.raises(ValueError, match='device="cpu"'):
        repro_torch.decompress(blob, "numpy", device=dev)
