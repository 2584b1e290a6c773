"""The "xla" and "pallas" SL stepper kernels on the card.

For each of the two variants, K4 (``sl_step_batched_<variant>``), K3
(``sl_decode_<variant>``) and its unit-batched entry
(``sl_decode_units_<variant>``) against their plain versions, bitwise,
on inputs whose substeps clamp, and on inputs where the variant's
integers differ from the "numpy" kernel's (the two f64 steppers part
only where a pixel takes many substeps: n_max 32); a
compress on the card with ``backend="pallas"`` / ``"xla"`` writes the
CPU's bytes; and the golden containers of tests/data (written by the JAX
package, tests/test_torch_sl_containers.py) decode on the card to the
reference's stored decode.  These tests need a CUDA device and nvcc;
elsewhere they skip.  The file imports no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_sl_variants.py
"""
import pytest

pytest.importorskip("torch")

from pathlib import Path

import numpy as np
import torch

import repro_torch
from repro_torch.core import predictors
from repro_torch.data import synthetic
from repro_torch.kernels.semilagrange import kernel as k3, ref as r3

pytestmark = pytest.mark.cuda

DATA = Path(__file__).resolve().parent / "data"
VARIANTS = ["xla", "pallas"]


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


# 3000 at cfl 0.1: departures near K4's halo edge; 50_000 at 0.2: 100-cell
# substeps clamped at n_max 32; 61x83 leaves partial tiles at the borders
@pytest.mark.parametrize("amp,cfl", [(50, 0.05), (3000, 0.1), (50_000, 0.2)])
@pytest.mark.parametrize("variant", VARIANTS)
def test_sl_batched_kernel_equals_plain(dev, variant, amp, cfl):
    rng = np.random.default_rng(amp)
    xu = torch.as_tensor(rng.integers(-amp, amp + 1, (5, 61, 83)), device=dev)
    xv = torch.as_tensor(rng.integers(-amp, amp + 1, (5, 61, 83)), device=dev)
    xu[2] //= 100
    args = (0.01, cfl, cfl, 2.0, 32)
    fn = getattr(k3, f"sl_step_batched_{variant}")
    n0 = fn.launches
    got = fn(xu, xv, *args)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    assert _same(got, r3.sl_step_batched(xu, xv, *args, variant))
    # non-vacuous: the "numpy" kernel gives other integers, the f32 one's
    # from departures of a few cells on, the f64 "xla" one's where the
    # substeps clamp
    if amp >= (3000 if variant == "pallas" else 50_000):
        assert not _same(got, k3.sl_step_batched(xu, xv, *args))


def _decode_inputs(shape, block, amp, dev, lead=()):
    rng = np.random.default_rng([block, amp, *shape])
    T, H, W = shape
    nb = tuple(lead) + (T, -(-H // block), -(-W // block))
    res = [torch.as_tensor(rng.integers(-amp, amp + 1, tuple(lead) + shape),
                           device=dev) for _ in range(2)]
    bm = rng.random(nb) < 0.4
    flags = bm.reshape(tuple(lead) + (T, -1)).any(axis=-1)
    flags[..., 0] = False
    c2 = [predictors.c2_block(r, block).contiguous() for r in res]
    return (*c2, *res, torch.as_tensor(bm.astype(np.uint8), device=dev),
            torch.as_tensor(flags.astype(np.uint8), device=dev))


# (residual amplitude, cfl, n_max): RK2 only / substeps clamped at n_max /
# up to 32 substeps of about d_max, where both variants' integers differ
# from the "numpy" kernel's
_AMPS = {"rk2": (20, 0.05, 8), "clamped": (400, 0.5, 4),
         "long": (2000, 0.9, 32)}


@pytest.mark.parametrize("shape,block,amp", [
    ((6, 37, 53), 16, "rk2"), ((6, 37, 53), 8, "clamped"),
    ((120, 100, 225), 16, "clamped"), ((16, 512, 512), 40, "clamped"),
    ((6, 37, 53), 8, "long")])
@pytest.mark.parametrize("variant", VARIANTS)
def test_sl_decode_kernel_equals_plain(dev, variant, shape, block, amp):
    a, cfl, n_max = _AMPS[amp]
    args = _decode_inputs(shape, block, a, dev) + (
        block, 0.01, cfl, 0.7 * cfl, 2.0, n_max)
    fn = getattr(k3, f"sl_decode_{variant}")
    n0 = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1 and fn.grid >= 1
    assert _same(got, r3.sl_decode(*args, variant))
    if amp == "long":
        assert not _same(got, k3.sl_decode(*args))


@pytest.mark.parametrize("B,shape,block,amp", [
    (1, (32, 128, 128), 16, "clamped"), (3, (12, 37, 53), 13, "clamped"),
    (3, (12, 37, 53), 13, "long")])
@pytest.mark.parametrize("variant", VARIANTS)
def test_sl_decode_units_kernel_equals_plain(dev, variant, B, shape, block,
                                             amp):
    a, cfl, n_max = _AMPS[amp]
    args = _decode_inputs(shape, block, a, dev, lead=(B,)) + (
        block, 0.01, cfl, 0.7 * cfl, 2.0, n_max)
    fn = getattr(k3, f"sl_decode_units_{variant}")
    got = fn(*args)
    torch.cuda.synchronize()
    assert _same(got, r3.sl_decode_units(*args, variant))
    if amp == "long":
        assert not _same(got, k3.sl_decode_units(*args))


@pytest.mark.parametrize("codec", ["host", "device"])
@pytest.mark.parametrize("backend", VARIANTS)
@pytest.mark.parametrize("H", [32, 30])
def test_card_blob_equals_cpu_blob(dev, backend, H, codec):
    """backend="pallas" on H = 32 runs the f32 kernels, on H = 30 the f64
    "xla" ones (the reference's rule); both give the CPU's bytes."""
    u, v = synthetic.vortex_street(T=6, H=H, W=40)
    rng = np.random.default_rng(H)
    u, v = ((a + 2.0 * rng.standard_normal(a.shape)).astype(np.float32)
            for a in (u, v))
    cfg = repro_torch.CompressionConfig(eb=1e-2, dt=40.0, n_max=8,
                                        backend=backend, codec=codec)
    want = backend if H % 8 == 0 else "xla"
    fn = getattr(k3, f"sl_step_batched_{want}")
    n0 = fn.launches
    blob, _ = repro_torch.compress(u, v, cfg, device=dev)
    assert fn.launches > n0
    assert blob == repro_torch.compress(u, v, cfg, device="cpu")[0]
    for a, b in zip(repro_torch.decompress(blob, device=dev),
                    repro_torch.decompress(blob, device="cpu")):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", ["pallas", "xla"])
def test_golden_containers_decode_on_card(dev, name):
    blob = (DATA / f"golden_sl_{name}.cptl").read_bytes()
    stored = np.load(DATA / f"golden_sl_{name}_decode.npz")
    fn = getattr(k3, f"sl_decode_{name}")
    n0 = fn.launches
    ur, vr = repro_torch.decompress(blob, device=dev)
    assert fn.launches == n0 + 1
    assert np.array_equal(ur.view(np.uint32), stored["ur"].view(np.uint32))
    assert np.array_equal(vr.view(np.uint32), stored["vr"].view(np.uint32))
