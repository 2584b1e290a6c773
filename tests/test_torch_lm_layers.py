"""The port's LM-scaffold layers (repro_torch.models: layers, moe, mamba,
rwkv) against the JAX package's (repro.models) on the same numpy inputs
and parameters, and the port's config registry against the reference's.

Tolerances: f32 ``rtol=atol=2e-4`` (the reference's own decode-vs-prefill
bound) unless a case states a tighter one; bf16 cases allow 2 bf16 ulps
of the output's magnitude (2 * 2^-8 relative).
"""
import pytest

pytest.importorskip("torch")

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.models import layers as JL
from repro.models import mamba as JM
from repro.models import moe as JE
from repro.models import rwkv as JR
from repro_torch.models import layers as TL
from repro_torch.models import mamba as TM
from repro_torch.models import moe as TE
from repro_torch.models import rwkv as TR
from repro_torch.models.layers import Params

from test_torch_lm_common import F32_TOL, configs, to_np

BF16_REL = 2 * 2.0 ** -8


def port_params(tree):
    """A JAX parameter dict (nested) -> the port's ``Params``."""
    def conv(t):
        return {k: conv(v) if isinstance(v, dict) else
                torch.from_numpy(np.array(v)) for k, v in t.items()}
    return Params(conv(tree))


def rand(rng, *shape, scale=1.0):
    return (rng.normal(0, 1, shape) * scale).astype(np.float32)


def both(a, dtype="float32"):
    """numpy f32 -> (jax array, torch tensor) in ``dtype``."""
    j = jnp.asarray(a).astype(dtype)
    t = torch.from_numpy(np.ascontiguousarray(a)).to(TL.torch_dtype(dtype))
    return j, t


def close(ref, got, **tol):
    np.testing.assert_allclose(to_np(got), to_np(ref), **(tol or F32_TOL))


def close_bf16(ref, got):
    ref, got = to_np(ref), to_np(got)
    bound = BF16_REL * max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(ref - got).max()) <= bound


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(20)


# ------------------------------------------------------------------ norms

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(rng, dtype):
    x = rand(rng, 2, 5, 64, scale=3.0)
    s = rand(rng, 64) + 1.0
    jx, tx = both(x, dtype)
    js, ts = both(s)
    ref, got = JL.rmsnorm(jx, js), TL.rmsnorm(tx, ts)
    assert got.dtype == TL.torch_dtype(dtype)
    (close if dtype == "float32" else close_bf16)(ref, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm(rng, dtype):
    x = rand(rng, 2, 5, 64, scale=3.0) + 1.0
    s, b = rand(rng, 64), rand(rng, 64)
    jx, tx = both(x, dtype)
    (js, ts), (jb, tb) = both(s), both(b)
    ref, got = JL.layernorm(jx, js, jb), TL.layernorm(tx, ts, tb)
    (close if dtype == "float32" else close_bf16)(ref, got)


# ------------------------------------------------------------------ rotary

def test_rope(rng):
    pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
    ja = JL.rope_angles(jnp.asarray(pos), 16, 5e6)
    ta = TL.rope_angles(torch.from_numpy(pos), 16, 5e6)
    close(ja, ta, rtol=1e-6, atol=2e-3)     # angles up to 4095 rad
    x = rand(rng, 2, 7, 3, 16)
    jx, tx = both(x)
    # the rotation itself, at the same angles: halves, not pairs
    ref = JL.apply_rope(jx, ja[:, :, None, :])
    got = TL.apply_rope(tx, torch.from_numpy(np.array(ja))[:, :, None, :])
    close(ref, got, rtol=1e-6, atol=1e-6)


def test_mrope(rng):
    pid = rng.integers(0, 50, (3, 2, 9)).astype(np.int32)
    ref = JL.mrope_angles(jnp.asarray(pid), 16, 1e6, (4, 2, 2))
    got = TL.mrope_angles(torch.from_numpy(pid), 16, 1e6, (4, 2, 2))
    close(ref, got, rtol=1e-6, atol=1e-5)


# ------------------------------------------------------------------ attention

def _qkv(rng, B, Sq, Skv, hkv=2, g=2, hd=16, dtype="float32"):
    q = both(rand(rng, B, Sq, hkv, g, hd), dtype)
    k = both(rand(rng, B, Skv, hkv, hd), dtype)
    v = both(rand(rng, B, Skv, hkv, hd), dtype)
    return q, k, v


@pytest.mark.parametrize("Sq,Skv,chunk,causal", [
    (32, 32, 64, True),     # one block
    (32, 32, 8, True),      # query-chunked
    (16, 24, 8, True),      # chunked, mask tril(k = Skv - Sq)
    (16, 24, 16, True),     # Sq == chunk: unchunked
    (12, 12, 8, True),      # chunk does not divide Sq: unchunked
    (32, 20, 8, False),     # encoder / cross attention
])
def test_causal_attention(rng, Sq, Skv, chunk, causal):
    cfg, tcfg = configs("yi_6b", dtype="float32")
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 2, Sq, Skv)
    ref = JL.causal_attention(cfg, jq, jk, jv, causal=causal, chunk=chunk)
    got = TL.causal_attention(tcfg, tq, tk, tv, causal=causal, chunk=chunk)
    close(ref, got, rtol=1e-5, atol=1e-5)


def test_quantize_kv_rounds_half_to_even_and_clips():
    # x * 16 on half-way points, and beyond +-127
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 7.9, -7.9, 100.0, -100.0,
                  0.03125, 0.09375], np.float32) / 16.0
    x[7:9] *= 16.0
    jx, tx = both(x)
    ref = np.asarray(JL.quantize_kv(jx, jnp.int8))
    got = TL.quantize_kv(tx, torch.int8).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got[7] == 127 and got[8] == -127
    np.testing.assert_array_equal(got[:5], [0, 2, 2, 0, -2])


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_decode_attention(rng, cache_dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 2, 1, 20, dtype="bfloat16")
    if cache_dtype == "int8":
        jk, jv = JL.quantize_kv(jk, jnp.int8), JL.quantize_kv(jv, jnp.int8)
        tk = torch.from_numpy(np.array(jk))
        tv = torch.from_numpy(np.array(jv))
    length = 13                   # positions 13.. are masked out
    ref = JL.decode_attention(jq, jk, jv, jnp.int32(length))
    got = TL.decode_attention(tq, tk, tv, torch.tensor(length,
                                                       dtype=torch.int32))
    assert got.dtype == (torch.float32 if cache_dtype == "int8"
                         else torch.bfloat16)
    (close if cache_dtype == "int8" else close_bf16)(ref, got)


# ------------------------------------------------------------------ mlp etc.

@pytest.mark.parametrize("arch", ["yi_6b", "whisper_small"])  # swiglu, gelu
def test_mlp(rng, arch):
    cfg, tcfg = configs(arch, dtype="float32")
    p = JL.mlp_params(cfg, jax.random.PRNGKey(3))
    if cfg.mlp == "gelu":
        p["b_up"] = jnp.asarray(rand(rng, cfg.d_ff))
        p["b_down"] = jnp.asarray(rand(rng, cfg.d_model))
    jx, tx = both(rand(rng, 2, 5, cfg.d_model))
    close(JL.apply_mlp(cfg, p, jx), TL.apply_mlp(tcfg, port_params(p), tx),
          rtol=1e-5, atol=1e-5)


def test_gelu_is_the_tanh_approximation(rng):
    x = rand(rng, 1000, scale=4.0)
    jx, tx = both(x)
    got = torch.nn.functional.gelu(tx, approximate="tanh")
    close(jax.nn.gelu(jx), got, rtol=1e-6, atol=1e-6)
    exact = torch.nn.functional.gelu(tx)
    assert float((exact - got).abs().max()) > 1e-4


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "yi_6b"])  # tied, untied
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_unembed(rng, arch, dtype):
    cfg, tcfg = configs(arch, dtype=dtype)
    p = JL.embed_params(cfg, jax.random.PRNGKey(4))
    tp = port_params(p)
    toks = rng.integers(0, cfg.vocab, (2, 6)).astype(np.int32)
    e_ref = JL.embed(cfg, p, jnp.asarray(toks))
    e_got = TL.embed(tcfg, tp, torch.from_numpy(toks))
    np.testing.assert_array_equal(to_np(e_got), to_np(e_ref))
    jx, tx = both(rand(rng, 2, 3, cfg.d_model), dtype)
    ref, got = JL.unembed(cfg, p, jx), TL.unembed(tcfg, tp, tx)
    assert got.dtype == torch.float32
    (close if dtype == "float32" else close_bf16)(ref, got)


def test_sinusoidal_positions():
    ref = JL.sinusoidal_positions(40, 64, jnp.float32)
    got = TL.sinusoidal_positions(40, 64, torch.float32, "cpu")
    close(ref, got, rtol=1e-5, atol=1e-5)


def test_param_cast_is_held_and_refreshed():
    p = Params({"w": torch.ones(3, 4)})
    a = p.cast("w", torch.bfloat16)
    assert p.cast("w", torch.bfloat16) is a
    with torch.no_grad():
        p["w"].mul_(2.0)
    assert float(p.cast("w", torch.bfloat16)[0, 0]) == 2.0
    assert p.cast("w", torch.float32) is p["w"]


# ------------------------------------------------------------------ moe

def _capture_reference_moe(monkeypatch, cfg, p, x):
    """The reference's apply_moe, with its dispatch and combine tensors
    (the einsum operands) recorded."""
    seen = {}
    einsum = jnp.einsum

    def recording(spec, *ops, **kw):
        if spec == "gsd,gsec->egcd":
            seen["dispatch"] = np.asarray(ops[1])
        if spec == "egcd,gsec->gsd":
            seen["combine"] = np.asarray(ops[1])
        return einsum(spec, *ops, **kw)

    monkeypatch.setattr(jnp, "einsum", recording)
    out, aux = JE.apply_moe(cfg, p, x)
    monkeypatch.setattr(jnp, "einsum", einsum)
    return out, aux, seen


@pytest.mark.parametrize("arch,B,S,cf", [
    ("olmoe_1b_7b", 2, 24, 0.5),      # one ragged group, drops
    ("llama4_scout_17b_16e", 2, 1024, 0.6),  # two groups of 1024, shared
    ("olmoe_1b_7b", 2, 24, 1.25),     # the default capacity factor
])
def test_apply_moe_routing_and_drops(rng, monkeypatch, arch, B, S, cf):
    cfg, tcfg = configs(arch, dtype="float32", capacity_factor=cf)
    p = JE.moe_params(cfg, jax.random.PRNGKey(5))
    p["router"] = p["router"] * 50.0   # sharp routing: queues overflow
    jx, tx = both(rand(rng, B, S, cfg.d_model))
    ref, ref_aux, seen = _capture_reference_moe(monkeypatch, cfg, p, jx)
    tp = port_params(p)
    r = TE.route(tcfg, tp, tx)
    np.testing.assert_array_equal(r["dispatch"].numpy(), seen["dispatch"])
    # the gates: an f32 softmax of f32 router sums in another order
    np.testing.assert_allclose(r["combine"].numpy(), seen["combine"],
                               rtol=1e-5, atol=1e-6)
    # keep: (token, k) placed in its expert's queue
    keep_ref = np.take_along_axis(
        seen["dispatch"].sum(-1), r["expert_idx"].numpy(), axis=-1) > 0
    np.testing.assert_array_equal(r["keep"].numpy(), keep_ref)
    if cf < 1.0:
        assert not keep_ref.all()      # the capacity drops tokens
    got, aux = TE.apply_moe(tcfg, tp, tx)
    close(ref, got, rtol=1e-5, atol=1e-5)
    close(ref_aux, aux, rtol=1e-6, atol=1e-6)


def test_moe_top_k_ties_go_to_the_lower_index(rng):
    cfg, tcfg = configs("olmoe_1b_7b", dtype="float32")
    p = JE.moe_params(cfg, jax.random.PRNGKey(6))
    p["router"] = jnp.zeros_like(p["router"])   # every expert ties
    jx, tx = both(rand(rng, 1, 8, cfg.d_model))
    r = TE.route(tcfg, port_params(p), tx)
    probs = jax.nn.softmax(jnp.zeros((1, 8, cfg.n_experts)), axis=-1)
    _, ref_idx = jax.lax.top_k(probs, cfg.top_k)
    np.testing.assert_array_equal(r["expert_idx"].numpy(),
                                  np.asarray(ref_idx))
    close(JE.apply_moe(cfg, p, jx)[0], TE.apply_moe(tcfg, port_params(p),
                                                    tx)[0])


# ------------------------------------------------------------------ mamba

@pytest.fixture(scope="module")
def mamba_case():
    cfg, tcfg = configs("jamba_1_5_large", dtype="float32")
    p = JM.mamba_params(cfg, jax.random.PRNGKey(7))
    r = np.random.default_rng(8)
    p["conv_b"] = jnp.asarray(rand(r, JM.d_inner(cfg), scale=0.1))
    p["dt_bias"] = jnp.asarray(rand(r, JM.d_inner(cfg), scale=0.5))
    return cfg, tcfg, p, port_params(p)


@pytest.mark.parametrize("S", [24, 13])     # 3 scan chunks; one ragged chunk
def test_mamba_forward_and_state(rng, mamba_case, S):
    cfg, tcfg, p, tp = mamba_case
    jx, tx = both(rand(rng, 2, S, cfg.d_model))
    ref, ref_st = JM.mamba_forward(cfg, p, jx, return_state=True)
    got, st = TM.mamba_forward(tcfg, tp, tx, return_state=True)
    # the port's sequential scan vs the reference's associative scan:
    # another association order of the same f32 recurrence
    close(ref, got)
    close(ref_st["conv"], st["conv"])
    close(ref_st["ssm"], st["ssm"])


def test_mamba_decode_step(rng, mamba_case):
    cfg, tcfg, p, tp = mamba_case
    di = JM.d_inner(cfg)
    conv = rand(rng, 2, cfg.mamba_d_conv - 1, di)
    ssm = rand(rng, 2, di, cfg.mamba_d_state)
    jx, tx = both(rand(rng, 2, 1, cfg.d_model))
    ref, ref_st = JM.mamba_decode_step(
        cfg, p, jx, {"conv": jnp.asarray(conv), "ssm": jnp.asarray(ssm)})
    st0 = TM.mamba_init_state(tcfg, 2, device="cpu")
    st0["conv"].copy_(torch.from_numpy(conv))
    st0["ssm"].copy_(torch.from_numpy(ssm))
    got, st = TM.mamba_decode_step(tcfg, tp, tx, st0)
    close(ref, got, rtol=1e-5, atol=1e-5)
    close(ref_st["conv"], st["conv"], rtol=0, atol=0)
    close(ref_st["ssm"], st["ssm"], rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ rwkv

@pytest.fixture(scope="module")
def rwkv_case():
    cfg, tcfg = configs("rwkv6_3b", dtype="float32")
    p = JR.rwkv_params(cfg, jax.random.PRNGKey(9))
    r = np.random.default_rng(10)
    d = cfg.d_model
    for name in ("mix_r", "mix_k", "mix_v", "mix_g", "mix_w", "cmix_k",
                 "cmix_r"):
        p[name] = jnp.asarray(r.uniform(0, 1, d).astype(np.float32))
    p["w0"] = jnp.asarray(rand(r, d, scale=0.5) - 1.0)
    return cfg, tcfg, p, port_params(p)


@pytest.mark.parametrize("S,chunk", [(24, 8), (24, None), (10, 4)])
def test_time_mix_chunked_with_state(rng, rwkv_case, S, chunk):
    cfg, tcfg, p, tp = rwkv_case
    H, hd = JR.n_heads(cfg), cfg.rwkv_head_dim
    state = rand(rng, 2, H, hd, hd, scale=0.3)
    last = rand(rng, 2, 1, cfg.d_model)
    jx, tx = both(rand(rng, 2, S, cfg.d_model))
    ref = JR.time_mix(cfg, p, jx, chunk=chunk, state=jnp.asarray(state),
                      last_x=jnp.asarray(last))
    got = TR.time_mix(tcfg, tp, tx, chunk=chunk,
                      state=torch.from_numpy(state),
                      last_x=torch.from_numpy(last))
    for a, b in zip(ref, got):       # out, final state, last x
        close(a, b)


def test_time_mix_decode_and_channel_mix(rng, rwkv_case):
    cfg, tcfg, p, tp = rwkv_case
    H, hd = JR.n_heads(cfg), cfg.rwkv_head_dim
    state = rand(rng, 2, H, hd, hd, scale=0.3)
    last = rand(rng, 2, 1, cfg.d_model)
    jx, tx = both(rand(rng, 2, 1, cfg.d_model))
    ref = JR.time_mix_decode(cfg, p, jx, jnp.asarray(state), jnp.asarray(last))
    got = TR.time_mix_decode(tcfg, tp, tx, torch.from_numpy(state),
                             torch.from_numpy(last))
    for a, b in zip(ref, got):
        close(a, b, rtol=1e-5, atol=1e-5)
    jx, tx = both(rand(rng, 2, 7, cfg.d_model))
    for lx in (None, last):
        ref = JR.channel_mix(cfg, p, jx, None if lx is None else
                             jnp.asarray(lx))
        got = TR.channel_mix(tcfg, tp, tx, None if lx is None else
                             torch.from_numpy(lx))
        for a, b in zip(ref, got):
            close(a, b, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ registry

def test_registry_lists_the_reference_archs():
    assert TC.ARCHS == JC.ARCHS
    assert TC.SHAPE_TABLE == JC.SHAPE_TABLE
    assert [dataclasses.asdict(c) for c in TC.standard_cells(3).values()] \
        == [dataclasses.asdict(c) for c in JC.standard_cells(3).values()]
    assert all(m.__name__.startswith("repro_torch.configs.")
               for m in TC.all_archs())


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_arch_config_equals_reference(arch):
    jm, tm = JC.get(arch), TC.get(arch)
    for name in ("CONFIG", "SMOKE"):
        jc, tc = getattr(jm, name), getattr(tm, name)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.head_dim == jc.head_dim
        assert tc.layer_kinds == jc.layer_kinds
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
        assert TL.dtype_of(tc) == TL.torch_dtype(jc.dtype)
    assert set(tm.CELLS) == set(jm.CELLS)
    for shape, cell in jm.CELLS.items():
        assert dataclasses.asdict(tm.CELLS[shape]) == dataclasses.asdict(cell)
        ref = JC.input_specs(jm.CONFIG, cell)
        got = TC.input_specs(tm.CONFIG, tm.CELLS[shape])
        assert set(got) == set(ref)
        for k, spec in ref.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(spec.shape)
            assert str(got[k].dtype).replace("torch.", "") == \
                jnp.dtype(spec.dtype).name
