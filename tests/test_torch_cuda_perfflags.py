"""``REPRO_BACKEND=numpy`` on the card: the plain versions of the kernels
run on the CPU only, so a compress or decompress on CUDA is refused and
launches no kernel.

Needs a CUDA device and nvcc; elsewhere it skips with the reason.  The
file imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q --noconftest \\
        tests/test_torch_cuda_perfflags.py
"""
import pytest

pytest.importorskip("torch")

import torch

import repro_torch
from repro_torch.data import synthetic
from repro_torch.kernels.cptest import kernel as k2
from repro_torch.kernels.entropy import kernel as k5
from repro_torch.kernels.lorenzo import kernel as k1
from repro_torch.kernels.semilagrange import kernel as k3

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("codec", ["host", "device"])
def test_backend_numpy_refuses_the_card(dev, codec, monkeypatch):
    """Under REPRO_BACKEND=numpy a compress and a decompress on the card
    raise ValueError naming device="cpu" and launch no kernel; the CPU
    run gives the card's bytes and fields."""
    u, v = synthetic.vortex_street(T=6, H=48, W=64)
    cfg = repro_torch.CompressionConfig(eb=1e-2, dt=0.05, dx=2.0 / 63,
                                        dy=1.0 / 47, codec=codec)
    blob, _ = repro_torch.compress(u, v, cfg, device=dev)
    fields = repro_torch.decompress(blob, device=dev)
    fns = (k1.lorenzo_residual, k2.verify_faces, k3.sl_decode,
           k3.sl_step_batched, k5.symbol_histogram)
    before = [f.launches for f in fns]
    monkeypatch.setenv("REPRO_BACKEND", "numpy")
    with pytest.raises(ValueError, match='device="cpu"'):
        repro_torch.compress(u, v, cfg, device=dev)
    with pytest.raises(ValueError, match='device="cpu"'):
        repro_torch.decompress(blob, device=dev)
    assert [f.launches for f in fns] == before
    plain, _ = repro_torch.compress(u, v, cfg, device="cpu")
    assert plain == blob
    for a, b in zip(fields, repro_torch.decompress(plain, device="cpu")):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
