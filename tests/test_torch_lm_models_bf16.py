"""Whole-model parity of the port's LM scaffold at the default bf16
activations: every architecture of the registry at its SMOKE size (f32
parameters), the JAX package's parameters carried across, through
prefill (logits and every cache tensor) and four teacher-forced decode
steps on a padded cache (logits and the final cache).

Tolerance: max |port - reference| <= 0.05 * max(1, max |reference|) per
tensor.  bf16 rounds at other points in the two packages (XLA fuses
element-wise chains in f32, torch rounds after each op); the largest
relative difference found is 0.024 (rwkv6 decode logits).  An int8
cache entry may differ by one step (x * 16 rounded from differing
bf16 values).
"""
import pytest

pytest.importorskip("torch")

import numpy as np

import repro.configs as JC

import test_torch_lm_common as H
from test_torch_lm_common import _one_torch_thread  # noqa: F401

BF16_TOL = 0.05


@pytest.fixture(scope="module")
def runs():
    """Both packages' results, computed once per architecture."""
    memo = {}

    def get(arch):
        if arch not in memo:
            memo[arch] = H.run_both(arch, dtype="bfloat16")
        return memo[arch]["jax"], memo[arch]["port"]
    return get


def _close(ref, got):
    assert got.shape == ref.shape
    bound = BF16_TOL * max(1.0, float(np.abs(ref).max())) if ref.size else 0
    assert H.max_err(ref, got) <= bound


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_prefill_logits_bf16(runs, arch):
    ref, got = runs(arch)
    _close(ref["prefill_logits"], got["prefill_logits"])


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_prefill_cache_bf16(runs, arch):
    ref, got = runs(arch)
    assert set(got["prefill_cache"]) == set(ref["prefill_cache"])
    for k, v in ref["prefill_cache"].items():
        assert got["prefill_cache"][k].dtype == v.dtype, k
        _close(v, got["prefill_cache"][k])


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_decode_steps_bf16(runs, arch):
    ref, got = runs(arch)
    for a, b in zip(ref["decode_logits"], got["decode_logits"]):
        _close(a, b)
    for k, v in ref["decode_cache"].items():
        _close(v, got["decode_cache"][k])


def test_head_padded_int8_cache_bf16():
    r = H.run_both("qwen1_5_32b", dtype="bfloat16", decode_head_pad=8,
                   cache_dtype="int8")
    ref, got = r["jax"], r["port"]
    for a, b in zip(ref["decode_logits"], got["decode_logits"]):
        _close(a, b)
    for k in ("k", "v"):
        c = got["decode_cache"][k]
        assert c.dtype == np.int8 and c.shape[3] == 8
        assert H.max_err(ref["decode_cache"][k], c) <= 1
        assert not c[:, :, :, 5:].any()
