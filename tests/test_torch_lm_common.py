"""Shared drive of the LM-scaffold parity tests (tests/test_torch_lm_*.py):
one configuration through the JAX package (``repro.models``) and the port
(``repro_torch.models``) with the same parameters and inputs; and the
tests of that carry-over (``convert.params_from_jax``).

Parameters come from the JAX package's ``model.init(PRNGKey(seed))``,
carried across by ``repro_torch.models.convert.load_params``; inputs are
numpy arrays from a seeded generator.  JAX runs on the CPU, the port with
``device="cpu"``.
"""
from __future__ import annotations

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
from repro.models.transformer import build_model as jax_build
from repro_torch.models.convert import load_params, params_from_jax
from repro_torch.models.transformer import build_model as port_build

# prompt length of the whole-model cases: above every SMOKE attn_chunk (16)
# and a multiple of it, so prefill runs the query-chunked attention, and
# several Mamba / RWKV scan chunks (8)
B, S, N_DECODE = 2, 32, 4
F32_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's SMOKE steps are thousands of tiny ops: one intra-op
    thread runs them as fast alone and does not oversubscribe the cores
    when several test processes share them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch, **override):
    """(the JAX package's SMOKE config, the port's), with ``override``."""
    jc = dataclasses.replace(JC.get(arch).SMOKE, **override)
    tc = dataclasses.replace(TC.get(arch).SMOKE, **override)
    return jc, tc


def to_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy().copy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def to_jax(a):
    return jnp.asarray(a)


def to_torch(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def models(jc, tc, seed=0):
    """(JAX model, JAX params, port model holding the same params)."""
    jm = jax_build(jc)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = port_build(tc, device="cpu")
    load_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def prompt(cfg, rng, batch=B, seq=S):
    """A numpy prefill batch for ``cfg``."""
    if cfg.is_encoder_decoder:
        return {"frames": rng.normal(0, 1, (batch, seq, cfg.d_model))
                .astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab, (batch, 8))
                .astype(np.int32)}
    if cfg.embedding_inputs:
        pid = np.broadcast_to(np.arange(seq, dtype=np.int32)[None, None],
                              (3, batch, seq))
        return {"embeds": rng.normal(0, 1, (batch, seq, cfg.d_model))
                .astype(np.float32), "position_ids": pid.copy()}
    return {"tokens": rng.integers(0, cfg.vocab, (batch, seq))
            .astype(np.int32)}


def step_inputs(cfg, rng, n=N_DECODE, batch=B):
    """``n`` numpy decode-step batches (teacher forced)."""
    if cfg.embedding_inputs:
        return [{"embeds": rng.normal(0, 1, (batch, 1, cfg.d_model))
                 .astype(np.float32)} for _ in range(n)]
    return [{"tokens": rng.integers(0, cfg.vocab, (batch, 1))
             .astype(np.int32)} for _ in range(n)]


def _batch_size(batch) -> int:
    return (batch["tokens"] if "tokens" in batch else batch["embeds"]).shape[0]


def _init_kw(cfg, batch):
    return {"enc_len": batch["frames"].shape[1]} if cfg.is_encoder_decoder \
        else {}


def jax_pad(jm, cfg, cache, batch, max_len, dtype=None):
    """The JAX prefill cache carried whole into ``init_cache(.., max_len)``
    (as the port's ``serve.pad_cache`` does)."""
    kw = _init_kw(cfg, batch)
    if dtype is not None:
        kw["dtype"] = dtype
    full = jm.init_cache(_batch_size(batch), max_len, **kw)
    for key, t in cache.items():
        if key in ("k", "v"):
            full[key] = full[key].at[:, :, :t.shape[2], :t.shape[3]].set(
                JL.quantize_kv(t, full[key].dtype))
        else:
            full[key] = t.astype(full[key].dtype) if key != "length" else t
    return full


def port_pad(tm, cfg, cache, batch, max_len, dtype=None):
    from repro_torch.launch import serve

    kw = _init_kw(cfg, batch)
    if dtype is not None:
        kw["dtype"] = dtype
    return serve.pad_cache(tm, cache, _batch_size(batch), max_len, **kw)


def run_both(arch, seed=0, cache_dtype=None, **override):
    """Prefill, ``N_DECODE`` teacher-forced decode steps on a padded
    cache and ``N_DECODE`` greedy steps, in both packages.  Returns
    {"jax": ..., "port": ...} of numpy results."""
    jc, tc = configs(arch, **override)
    jm, params, tm = models(jc, tc, seed)
    rng = np.random.default_rng(seed + 1)
    batch = prompt(jc, rng)
    steps = step_inputs(jc, rng)
    max_len = (8 if jc.is_encoder_decoder else S) + 2 * N_DECODE
    jprefill = jax.jit(jm.prefill)
    jdecode = jax.jit(jm.decode_step)

    out = {}
    # reference
    jb = {k: to_jax(v) for k, v in batch.items()}
    logits, cache = jprefill(params, jb)
    res = {"prefill_logits": to_np(logits),
           "prefill_cache": {k: to_np(v) for k, v in cache.items()}}
    c = jax_pad(jm, jc, cache, batch, max_len, cache_dtype)
    res["decode_logits"] = []
    for st in steps:
        lg, c = jdecode(params, {k: to_jax(v) for k, v in st.items()}, c)
        res["decode_logits"].append(to_np(lg))
    res["decode_cache"] = {k: to_np(v) for k, v in c.items()}
    res["greedy"] = _greedy(jc, logits,
                            jax_pad(jm, jc, cache, batch, max_len,
                                    cache_dtype),
                            lambda b, cc: jdecode(params, b, cc), to_jax,
                            steps)
    out["jax"] = res

    # port
    tb = {k: to_torch(v) for k, v in batch.items()}
    logits, cache = tm.prefill(tb)
    res = {"prefill_logits": to_np(logits),
           "prefill_cache": {k: to_np(v) for k, v in cache.items()}}
    c = port_pad(tm, tc, cache, batch, max_len, cache_dtype)
    res["decode_logits"] = []
    for st in steps:
        lg, c = tm.decode_step({k: to_torch(v) for k, v in st.items()}, c)
        res["decode_logits"].append(to_np(lg))
    res["decode_cache"] = {k: to_np(v) for k, v in c.items()}
    res["greedy"] = _greedy(tc, logits,
                            port_pad(tm, tc, cache, batch, max_len,
                                     cache_dtype),
                            tm.decode_step, to_torch, steps)
    out["port"] = res
    return out


def _greedy(cfg, logits, cache, decode, conv, steps):
    """Greedy tokens of ``len(steps)`` decode steps from a prefill (the
    embedding-input family feeds the steps' embeddings)."""
    toks = []
    for st in steps:
        nxt = np.argmax(to_np(logits)[:, -1:], axis=-1).astype(np.int32)
        toks.append(nxt)
        feed = st if cfg.embedding_inputs else {"tokens": nxt}
        logits, cache = decode({k: conv(v) for k, v in feed.items()}, cache)
    toks.append(np.argmax(to_np(logits)[:, -1:], axis=-1).astype(np.int32))
    return np.concatenate(toks, axis=1)


def max_err(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) if a.size else 0.0


# ------------------------------------------------------------ the carry-over

@pytest.mark.parametrize("arch", JC.ARCHS)
def test_params_from_jax_fills_the_port_state_dict(arch):
    """Every leaf of the reference's parameter tree lands on one port
    parameter of the same shape and dtype, and every port parameter gets
    one (the stacked layer / group axes unstacked)."""
    jc, tc = configs(arch)
    params = jax_build(jc).init(jax.random.PRNGKey(0))
    sd = params_from_jax(tc, jax.tree.map(np.asarray, params))
    port = port_build(tc, device="cpu").state_dict()
    assert set(sd) == set(port)
    for name, t in port.items():
        assert sd[name].shape == t.shape and sd[name].dtype == t.dtype, name
    assert sum(t.numel() for t in sd.values()) == \
        sum(np.asarray(x).size for x in jax.tree.leaves(params))


def test_params_from_jax_bf16_leaves():
    jc, tc = configs("jamba_1_5_large", param_dtype="bfloat16")
    params = jax_build(jc).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    sd = params_from_jax(tc, tree)
    w = sd["superblocks.0.1.mamba.in_proj"]
    assert w.dtype == torch.bfloat16
    ref = tree["superblocks"][1]["mamba"]["in_proj"][0]
    np.testing.assert_array_equal(w.float().numpy(), ref.astype(np.float32))
