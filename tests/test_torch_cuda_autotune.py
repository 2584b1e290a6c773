"""Autotuning, rate-targeted compression, the baselines and the metrics
on the card.

A calibration on the card fits all ten stages for each of its three
backend arms (SL steppers); a tuned plan (with a table favouring each
arm in turn: its container's ``sl_backend`` is that arm and only its
K3 / K4 kernels launch), a target-ratio search and the sz3-like /
cpsz-like baselines write on the card the bytes they write on the CPU; ``false_cases`` and ``evaluate``
run on the card by default and agree with the CPU.  These tests need a
CUDA device and nvcc; elsewhere they skip.  The file imports no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_autotune.py
"""
import pytest

pytest.importorskip("torch")

import numpy as np
import torch

import repro_torch
from repro_torch import autotune, baselines
from repro_torch.autotune import costmodel
from repro_torch.core import encode, metrics, trajectory
from repro_torch.data import synthetic
from repro_torch.kernels.semilagrange import kernel as k3

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _field(shape, seed=3):
    rng = np.random.default_rng(seed)
    base = np.cumsum(rng.normal(size=shape).astype(np.float32), axis=0)
    return base, base[::-1].copy()


ARMS = ("pallas", "xla", "numpy")


def _table(kind, mono, favour=None):
    """A fixed table in (backend, stage) keys over the card's arms;
    ``mono`` scales the monolithic stages, the arm ``favour`` costs half
    of the others (None: a tie, which the key breaks to "numpy")."""
    return autotune.CalibrationTable(device_kind=kind, coeffs={
        (be, s): (1e-4 * (i + 1) * (mono if i < 5 else 1.0)
                  * (0.5 if be == favour else 1.0),
                  1e-8 * (i + 2) * (mono if i < 5 else 1.0)
                  * (0.5 if be == favour else 1.0))
        for be in ARMS for i, s in enumerate(costmodel.STAGES)})


def _sl_wrappers():
    """{name: wrapper} of K3, its unit entry and K4 in every variant."""
    return {f"{b}{x}": getattr(k3, f"{b}{x}")
            for b in ("sl_decode", "sl_decode_units", "sl_step_batched")
            for x in k3.SUFFIX.values()}


def test_calibration_on_the_card_fits_every_stage(dev, tmp_path):
    path = str(tmp_path / "calib.json")
    table = autotune.calibrate(path=path, device=dev)
    assert table.device_kind == "gpu" and table.meta["backends"] == list(ARMS)
    assert autotune.available_backends(dev) == ARMS
    assert set(table.coeffs) == {(be, s) for be in ARMS
                                 for s in costmodel.STAGES}
    assert len(table.coeffs) == 30
    assert all(c0 >= 0 and c1 >= 0 for c0, c1 in table.coeffs.values())
    assert autotune.load_table(path, device=dev).coeffs == table.coeffs
    with pytest.raises(autotune.CalibrationTableError) as ei:
        autotune.load_table(path, device="cpu")
    assert ei.value.reason == "foreign"


@pytest.mark.parametrize("mono", [1.0, 1000.0])
def test_tuned_bytes_on_the_card_equal_the_cpu(dev, mono):
    u, v = _field((6, 32, 32))
    cfg = repro_torch.CompressionConfig(eb=1e-2)
    tuned = autotune.tune_config(u, v, cfg, table=_table("gpu", mono),
                                 measure=True, device=dev)
    rep = autotune.last_report()
    assert rep["device_kind"] == "gpu"
    assert sum(p["measured_s"] is not None for p in rep["plans"]) == 3
    card, _ = repro_torch.compress(u, v, tuned, device=dev)
    cpu, _ = repro_torch.compress(u, v, tuned, device="cpu")
    assert card == cpu


@pytest.mark.parametrize("favour", ARMS)
def test_tuned_arm_bytes_on_the_card_equal_the_cpu(dev, favour):
    """A table favouring one arm: the tuned plan runs that arm's stepper
    kernels only, its header names the arm, and the CPU (the plain
    versions; f32 for "pallas") writes the same bytes."""
    u, v = _field((6, 32, 32))
    cfg = repro_torch.CompressionConfig(eb=1e-2)
    tuned = autotune.tune_config(u, v, cfg, table=_table("gpu", 1.0, favour),
                                 measure=False, device=dev)
    assert autotune.last_report()["chosen"] == f"mono/{favour}/host"
    assert tuned.backend == (None if favour == "numpy" else favour)
    fns = _sl_wrappers()
    for fn in fns.values():
        fn.launches = 0
    card, _ = repro_torch.compress(u, v, tuned, device=dev)
    ran = {n for n, fn in fns.items() if fn.launches}
    sfx = k3.SUFFIX[favour]
    assert ran == {f"sl_step_batched{sfx}", f"sl_decode{sfx}"}, ran
    assert encode.unpack(card)[0]["sl_backend"] == favour
    cpu, _ = repro_torch.compress(u, v, tuned, device="cpu")
    assert card == cpu


def test_stream_autotune_on_the_card_equals_the_cpu(dev, monkeypatch):
    u, v = _field((8, 32, 48))
    cfg = repro_torch.CompressionConfig(eb=1e-2)
    out = {}
    for d, kind in ((dev, "gpu"), ("cpu", "cpu")):
        monkeypatch.setattr(autotune, "load_or_calibrate",
                            lambda path=None, device=None, k=kind:
                            _table(k, 1.0, "xla"))
        out[kind], _ = repro_torch.compress_stream(
            zip(u, v), cfg, autotune=True, n_frames_hint=8, device=d)
    assert out["gpu"] == out["cpu"]


def test_rate_search_on_the_card_equals_the_cpu(dev):
    u, v = synthetic.double_gyre(T=6, H=32, W=32)
    cfg = repro_torch.CompressionConfig(eb=1e-3, mode="abs")
    uniform = repro_torch.compress(u, v, cfg, device="cpu")[1]["ratio"]
    for factor in (0.5, 1.5):
        card, sc = repro_torch.compress(u, v, cfg, device=dev,
                                        target_ratio=uniform * factor)
        cpu, sp = repro_torch.compress(u, v, cfg, device="cpu",
                                       target_ratio=uniform * factor)
        assert card == cpu and sc["rate_target"] == sp["rate_target"]


@pytest.mark.parametrize("name", ["sz3-like", "cpsz-like", "zfp-like",
                                  "fpzip-like"])
def test_baselines_on_the_card_equal_the_cpu(dev, name):
    u, v = _field((6, 32, 32))
    card = baselines.REGISTRY[name](u, v, eb=1e-2, device=dev)
    cpu = baselines.REGISTRY[name](u, v, eb=1e-2, device="cpu")
    assert card["comp_bytes"] == cpu["comp_bytes"]
    for k in ("u_rec", "v_rec"):
        assert np.array_equal(card[k].view(np.uint32), cpu[k].view(np.uint32))


def test_metrics_default_to_the_card(dev):
    u, v = _field((4, 24, 24))
    blob, st = repro_torch.compress(u, v, device=dev)
    rng = np.random.default_rng(1)
    ur = u + 0.05 * rng.normal(size=u.shape).astype(np.float32)
    vr = v + 0.05 * rng.normal(size=v.shape).astype(np.float32)
    args = (u, v, ur, vr, st["scale"], st["orig_bytes"], st["comp_bytes"])
    assert metrics.evaluate(*args) == metrics.evaluate(*args, device="cpu")
    assert trajectory.false_cases(u, v, ur, vr, st["scale"]) \
        == trajectory.false_cases(u, v, ur, vr, st["scale"], device="cpu")
