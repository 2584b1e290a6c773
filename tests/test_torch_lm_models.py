"""Whole-model parity of the port's LM scaffold in f32: every
architecture of the registry at its SMOKE size, the JAX package's
parameters carried across, through prefill (logits and every cache
tensor), four teacher-forced decode steps on a padded cache (logits and
the final cache) and four greedy steps (tokens equal).

Tolerance: ``rtol=atol=2e-4`` (the reference's own
``test_decode_matches_prefill_dense`` bound); the runs differ by < 1e-5.
"""
import pytest

pytest.importorskip("torch")

import numpy as np

import repro.configs as JC

import test_torch_lm_common as H
from test_torch_lm_common import _one_torch_thread  # noqa: F401

DTYPE = "float32"


@pytest.fixture(scope="module")
def runs():
    """Both packages' results, computed once per architecture."""
    memo = {}

    def get(arch):
        if arch not in memo:
            memo[arch] = H.run_both(arch, dtype=DTYPE)
        return memo[arch]["jax"], memo[arch]["port"]
    return get


def _close(ref, got):
    np.testing.assert_allclose(got, ref, **H.F32_TOL)


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_prefill_logits(runs, arch):
    ref, got = runs(arch)
    assert got["prefill_logits"].shape == ref["prefill_logits"].shape
    _close(ref["prefill_logits"], got["prefill_logits"])


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_prefill_cache(runs, arch):
    ref, got = runs(arch)
    assert set(got["prefill_cache"]) == set(ref["prefill_cache"])
    for k, v in ref["prefill_cache"].items():
        assert got["prefill_cache"][k].shape == v.shape, k
        _close(v, got["prefill_cache"][k])


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_decode_steps(runs, arch):
    ref, got = runs(arch)
    for a, b in zip(ref["decode_logits"], got["decode_logits"]):
        _close(a, b)
    assert set(got["decode_cache"]) == set(ref["decode_cache"])
    for k, v in ref["decode_cache"].items():
        _close(v, got["decode_cache"][k])
    assert int(got["decode_cache"]["length"]) == \
        int(got["prefill_cache"]["length"]) + H.N_DECODE


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_greedy_tokens(runs, arch):
    ref, got = runs(arch)
    np.testing.assert_array_equal(got["greedy"], ref["greedy"])


def test_head_padded_int8_cache():
    """qwen1.5-32b's SMOKE with decode_head_pad (5 KV heads -> 8) and an
    int8 cache: the padded heads stay zero, the int8 cache entries and the
    decode logits equal the reference's."""
    r = H.run_both("qwen1_5_32b", dtype=DTYPE, decode_head_pad=8,
                   cache_dtype="int8")
    ref, got = r["jax"], r["port"]
    for a, b in zip(ref["decode_logits"], got["decode_logits"]):
        _close(a, b)
    for k in ("k", "v"):
        c = got["decode_cache"][k]
        assert c.shape[3] == 8 and c.dtype == np.int8
        np.testing.assert_array_equal(c, ref["decode_cache"][k])
        assert not c[:, :, :, 5:].any()
    np.testing.assert_array_equal(got["greedy"], ref["greedy"])
