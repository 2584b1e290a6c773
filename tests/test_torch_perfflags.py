"""The port's environment switches (``repro_torch.perfflags``) against the
JAX package's: ``REPRO_PERF_BASELINE`` (``BASELINE``: loss and gradients
of a SMOKE step equal the reference's baseline step, within PERF.md
section 2's LM bounds, and the chunk bodies are no longer recomputed),
``REPRO_FUSED=0`` (the legacy binding, as ``fused=False``), ``REPRO_BACKEND``
(``numpy``: the plain versions of the kernels on the CPU, CUDA tensors
refused; ``pallas`` / ``xla``: the JAX package's SL steppers of those
names and their header tag; any other name refused) and
``REPRO_JIT_CACHE`` (the kernel build directory)."""
import pytest

pytest.importorskip("torch")

from pathlib import Path

import jax
import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.perfflags as JP
import repro_torch
import repro_torch.perfflags as TP
from repro.models import layers as JL
from repro.models import transformer as JM
from repro_torch.data import synthetic
from repro_torch.kernels import _build, use_kernel
from repro_torch.models import layers as TL
from repro_torch.models.convert import params_to_jax
from repro_torch.opcost import CostMode
from repro_torch.train import train_step as TS

import test_torch_lm_common as H
from test_torch_lm_common import _one_torch_thread  # noqa: F401
from test_torch_train_step import assert_bf16, assert_leaves, batches

GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = 0.05
BASELINE_CASES = [("stablelm_1_6b", "bfloat16"), ("olmoe_1b_7b", "float32"),
                  ("jamba_1_5_large", "float32"), ("rwkv6_3b", "float32")]


def jax_params(tc, tm):
    """The port model's (f32) parameters in the reference's tree."""
    tree = params_to_jax(tc, dict(tm.named_parameters()))
    return jax.tree.map(lambda t: H.to_jax(t.detach().numpy()), tree)


@pytest.fixture()
def baseline(monkeypatch):
    monkeypatch.setattr(JP, "BASELINE", True)
    monkeypatch.setattr(TP, "BASELINE", True)


@pytest.mark.parametrize("arch,dtype", BASELINE_CASES)
def test_baseline_step_equals_reference(baseline, arch, dtype):
    jc, tc = H.configs(arch, dtype=dtype)
    jm = JM.build_model(jc)
    tm = H.port_build(tc, device="cpu")
    params = jax_params(tc, tm)
    jb, tb = batches(jc, tc, 0)
    (loss, _), grads = jax.jit(lambda p, b: jax.value_and_grad(
        jm.train_loss, has_aux=True)(p, b))(params, jb)
    tm.requires_grad_(True)
    named = dict(tm.named_parameters())
    tloss, _, tgrads = TS.value_and_grad(tm, named, tb)
    got = params_to_jax(tc, tgrads)
    if dtype == "float32":
        np.testing.assert_allclose(float(tloss), float(loss), **H.F32_TOL)
        assert_leaves(grads, got, **GRAD_TOL)
    else:
        assert abs(float(tloss) - float(loss)) \
            <= BF16_TOL * max(1.0, float(loss))
        assert_bf16(grads, got)


def test_baseline_rmsnorm_equals_reference(monkeypatch):
    """H5: BASELINE normalizes an f32 copy; the default multiplies in the
    activation dtype.  Each equals the reference's form bitwise (bf16)."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, (4, 8, 64)).astype(np.float32)
    scale = rng.normal(1, 0.1, (64,)).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xj = H.to_jax(x).astype("bfloat16")
    outs = {}
    for flag in (False, True):
        monkeypatch.setattr(JP, "BASELINE", flag)
        monkeypatch.setattr(TP, "BASELINE", flag)
        want = H.to_np(JL.rmsnorm(xj, H.to_jax(scale)))
        got = H.to_np(TL.rmsnorm(xt, torch.from_numpy(scale)))
        np.testing.assert_array_equal(got, want)
        outs[flag] = got
    assert not np.array_equal(outs[False], outs[True])


@pytest.mark.parametrize("arch", ["jamba_1_5_large", "rwkv6_3b"])
def test_chunk_bodies_recomputed_unless_baseline(monkeypatch, arch):
    """H2: the Mamba / RWKV chunk bodies run again in the backward pass
    (more ops, the same loss); BASELINE saves their activations."""
    _, tc = H.configs(arch, dtype="float32")
    ops, losses = {}, {}
    for flag in (False, True):
        monkeypatch.setattr(TP, "BASELINE", flag)
        tm = H.port_build(tc, device="cpu")
        tm.requires_grad_(True)
        named = dict(tm.named_parameters())
        _, tb = batches(*H.configs(arch, dtype="float32"), 0)
        with CostMode() as cm:
            losses[flag] = float(TS.value_and_grad(tm, named, tb)[0])
        ops[flag] = sum(cm.cost.op_counts.values())
    assert ops[False] > ops[True]
    assert losses[False] == losses[True]


@pytest.fixture(scope="module")
def field():
    return synthetic.double_gyre(T=3, H=8, W=10)


def test_fused_0_is_refused_like_fused_false(monkeypatch, field):
    """``REPRO_FUSED=0`` runs what ``fused=False`` runs (it was refused
    like it before the legacy binding was ported): the legacy container;
    the tiled entry ignores both, as the reference's does."""
    u, v = field
    legacy, _ = repro_torch.compress(
        u, v, repro_torch.CompressionConfig(fused=False), device="cpu")
    grid = repro_torch.TileGrid(4, 4, 2)
    tiled, _ = repro_torch.compress(
        u, v, repro_torch.CompressionConfig(tiling=grid), device="cpu")
    monkeypatch.setenv("REPRO_FUSED", "0")
    assert JP.fused_default() is TP.fused_default() is False
    blob, stats = repro_torch.compress(u, v, device="cpu")
    assert blob == legacy and stats["pipeline"] == "legacy"
    assert repro_torch.compress(u, v, repro_torch.CompressionConfig(
        tiling=grid), device="cpu")[0] == tiled
    # an explicit fused=True wins over the environment, as in the reference
    blob, _ = repro_torch.compress(
        u, v, repro_torch.CompressionConfig(fused=True), device="cpu")
    assert blob != legacy
    monkeypatch.setenv("REPRO_FUSED", "1")
    assert TP.fused_default() is True
    assert repro_torch.compress(u, v, device="cpu")[0] == blob


def test_backend_numpy_selects_the_plain_versions(monkeypatch, field):
    u, v = field
    blob, _ = repro_torch.compress(u, v, device="cpu")
    monkeypatch.setenv("REPRO_BACKEND", "numpy")
    assert JP.backend_override() == TP.backend_override() == "numpy"
    assert TP.plain_kernels()
    assert repro_torch.compress(u, v, device="cpu")[0] == blob
    assert not use_kernel(torch.zeros(1), "op")
    with pytest.raises(ValueError, match="device meta"):
        use_kernel(torch.zeros(1, device="meta"), "op")
    # the plain versions run on the CPU only: a (fake) CUDA tensor is
    # refused, naming device="cpu", and never given the plain version
    with FakeTensorMode():
        on_card = torch.empty(1, device="cuda")
    with pytest.raises(ValueError, match='device="cpu"'):
        use_kernel(on_card, "op")
    monkeypatch.delenv("REPRO_BACKEND")
    assert TP.backend_override() is None and not TP.plain_kernels()
    assert use_kernel(on_card, "op")


@pytest.mark.parametrize("name", ["pallas", "xla", "cuda"])
def test_backend_without_counterpart_is_refused(monkeypatch, field, name):
    """``pallas`` and ``xla`` select the JAX package's SL steppers of
    those names: the container's header carries the tag, an explicit
    ``CompressionConfig.backend`` wins over the environment, and the
    kernels stay on (a CPU tensor takes the plain version).  ``cuda``,
    a name the JAX package has no backend of, is refused."""
    from repro_torch.core import encode

    u, v = field
    monkeypatch.setenv("REPRO_BACKEND", name)
    assert JP.backend_override() == name
    if name == "cuda":
        with pytest.raises(ValueError, match=f"REPRO_BACKEND={name}"):
            repro_torch.compress(u, v, device="cpu")
        with pytest.raises(ValueError, match=f"REPRO_BACKEND={name}"):
            use_kernel(torch.zeros(1), "op")
        return
    assert TP.backend_override() == name and not TP.plain_kernels()
    assert not use_kernel(torch.zeros(1), "op")
    blob, _ = repro_torch.compress(u, v, device="cpu")
    assert encode.unpack(blob)[0]["sl_backend"] == name
    explicit, _ = repro_torch.compress(
        u, v, repro_torch.CompressionConfig(backend=name), device="cpu")
    assert explicit == blob
    numpy_blob, _ = repro_torch.compress(
        u, v, repro_torch.CompressionConfig(backend="numpy"), device="cpu")
    assert encode.unpack(numpy_blob)[0]["sl_backend"] == "numpy"
    monkeypatch.delenv("REPRO_BACKEND")
    assert repro_torch.compress(u, v, device="cpu")[0] == numpy_blob


def test_jit_cache_moves_the_build_directory(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_JIT_CACHE", raising=False)
    assert _build.build_dir() == _build.BUILD_DIR
    assert _build.lib_path("lorenzo").parent == _build.BUILD_DIR
    monkeypatch.setenv("REPRO_JIT_CACHE", "0")
    assert _build.build_dir() == _build.BUILD_DIR
    monkeypatch.setenv("REPRO_JIT_CACHE", str(tmp_path / "kernels"))
    assert TP.jit_cache_dir() == str(tmp_path / "kernels")
    assert _build.lib_path("entropy").parent == tmp_path / "kernels"
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("REPRO_JIT_CACHE", "1")
    assert _build.build_dir() == Path(tmp_path, ".cache", "repro_torch",
                                      "kernels")
