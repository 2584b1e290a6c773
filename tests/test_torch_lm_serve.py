"""The port's serving launcher (repro_torch.launch.serve) against plain
greedy loops over the JAX package's prefill / decode_step, the hybrid
family's cache splice, and the guards of the LM scaffold's entry points.
"""
import pytest

pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models.transformer import build_model as jax_build
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.models.convert import load_params

import test_torch_lm_common as H
from test_torch_lm_common import _one_torch_thread  # noqa: F401

# examples/serve_decode.py's arguments
EXAMPLE = ["--arch", "yi_6b", "--smoke", "--requests", "12", "--batch", "4",
           "--prompt-len", "32", "--gen-len", "12", "--device", "cpu"]


def serve_with_reference_params(argv, dtype=None):
    """``serve.run`` on a port model holding the reference's
    ``init(PRNGKey(seed))`` parameters (at ``dtype`` activations, default
    the config's), and the reference model and parameters."""
    args = serve.parse_args(argv)
    assert args.smoke
    override = {} if dtype is None else {"dtype": dtype}
    jcfg, tcfg = H.configs(args.arch, **override)
    jm = jax_build(jcfg)
    params = jm.init(jax.random.PRNGKey(args.seed))
    tm = T.build_model(tcfg, device="cpu")
    load_params(tm, jax.tree.map(np.asarray, params))
    return args, jcfg, jm, params, serve.run(args, model=tm)


def reference_greedy(jm, params, cfg, batch, n, max_len):
    """A plain greedy loop over the reference's prefill / decode_step:
    ``n`` tokens, each fed to the next step (zero embeddings for the
    embedding-input family)."""
    prefill, decode = _jitted(jm)
    logits, cache = prefill(params, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    cache = H.jax_pad(jm, cfg, cache, batch, max_len)
    toks = []
    for _ in range(n):
        nxt = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        toks.append(np.asarray(nxt))
        step = ({"embeds": jnp.zeros((nxt.shape[0], 1, cfg.d_model),
                                     jnp.bfloat16)}
                if cfg.embedding_inputs else {"tokens": nxt})
        logits, cache = decode(params, step, cache)
    return np.concatenate(toks, axis=1)


_JIT = {}


def _jitted(jm):
    """jit(prefill), jit(decode_step) of a reference model, made once."""
    if id(jm) not in _JIT:
        _JIT[id(jm)] = (jm, jax.jit(jm.prefill), jax.jit(jm.decode_step))
    return _JIT[id(jm)][1:]


def _request_batch(prompt):
    out = {}
    for k, v in prompt.items():
        v = v.float() if v.dtype == torch.bfloat16 else v
        a = v.numpy()
        out[k] = a.astype(jnp.bfloat16) if k == "embeds" else a
    return out


@pytest.mark.parametrize("argv", [
    EXAMPLE,
    ["--arch", "qwen2_vl_7b", "--smoke", "--requests", "5", "--batch", "2",
     "--gen-len", "6", "--device", "cpu"],
    ["--arch", "rwkv6_3b", "--smoke", "--requests", "5", "--batch", "2",
     "--gen-len", "6", "--device", "cpu"],
    ["--arch", "olmoe_1b_7b", "--smoke", "--requests", "5", "--batch", "2",
     "--gen-len", "6", "--device", "cpu"],
    ["--arch", "jamba_1_5_large", "--smoke", "--requests", "3", "--batch",
     "2", "--gen-len", "6", "--device", "cpu"],
], ids=["yi_6b-example", "qwen2_vl_7b", "rwkv6_3b", "olmoe_1b_7b",
        "jamba_1_5_large"])
def test_serve_tokens_equal_reference_greedy(argv):
    """f32: every request's tokens == the reference's greedy loop (the
    hybrid's reference loop carries the whole cache, as the port does)."""
    args, cfg, jm, params, out = serve_with_reference_params(argv, "float32")
    assert out["requests"] == out["prefills"] == args.requests
    assert out["decoded_tokens"] == args.requests * args.gen_len
    assert sorted(out["tokens"]) == list(range(args.requests))
    for rid, toks in out["tokens"].items():
        assert toks.shape == (args.gen_len,)
        ref = reference_greedy(jm, params, cfg,
                               _request_batch(out["prompts"][rid]),
                               args.gen_len, args.max_len)
        np.testing.assert_array_equal(toks, ref[0], err_msg=f"request {rid}")


def test_serve_bf16_tokens_are_reference_greedy_up_to_ties():
    """The example at its default bf16: the logits are bf16 products cast
    to f32, so exact ties at bf16 resolution occur (the reference's own
    top two logits equal), and which of the tied tokens wins then depends
    on the last bit of each package's bf16 rounding.  Teacher-forced
    through the reference, each of the port's tokens must be the
    reference's argmax, or tie it within the bf16 logits bound
    (test_torch_lm_models_bf16: 0.05 * max(1, |logits|)), and every step
    whose reference top two are further apart must pick the same token."""
    args, cfg, jm, params, out = serve_with_reference_params(EXAMPLE)
    prefill, decode = _jitted(jm)
    n_equal = n_steps = 0
    for rid, toks in out["tokens"].items():
        batch = _request_batch(out["prompts"][rid])
        logits, cache = prefill(params, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
        cache = H.jax_pad(jm, cfg, cache, batch, args.max_len)
        for tok in toks:
            lg = np.asarray(logits[0, -1], np.float64)
            bound = 0.05 * max(1.0, float(np.abs(lg).max()))
            top2 = np.sort(lg)[-2:]
            assert lg[tok] >= lg.max() - bound, (rid, tok)
            if top2[1] - top2[0] > bound:
                assert tok == int(np.argmax(lg)), (rid, tok)
            n_equal += tok == int(np.argmax(lg))
            n_steps += 1
            logits, cache = decode(params, {"tokens": jnp.asarray(
                [[tok]], jnp.int32)}, cache)
    assert n_steps == args.requests * args.gen_len
    assert n_equal >= 0.9 * n_steps


def test_serve_encoder_decoder_branch():
    argv = ["--arch", "whisper_small", "--smoke", "--batch", "2",
            "--gen-len", "6", "--device", "cpu"]
    args, cfg, jm, params, out = serve_with_reference_params(argv)
    assert out["prefills"] == 1 and out["decoded_tokens"] == 12
    rng = np.random.default_rng(args.seed)   # the launcher's draws
    batch = {"frames": rng.normal(0, 1, (2, args.prompt_len, cfg.d_model))
             .astype(np.float32),
             "tokens": rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)}
    ref = reference_greedy(jm, params, cfg, batch, args.gen_len,
                           args.max_len)
    got = np.stack([out["tokens"][r] for r in range(2)])
    np.testing.assert_array_equal(got, ref)


def test_serve_main_prints_the_summary_line(capsys):
    assert serve.main(["--arch", "yi_6b", "--smoke", "--requests", "3",
                       "--batch", "2", "--gen-len", "2", "--device",
                       "cpu"]) == 0
    line = capsys.readouterr().out.strip()
    assert line.startswith("[serve] 3 requests, 3 prefills, 6 tokens in ")
    assert line.endswith(" tok/s)")


# ------------------------------------------------------------ hybrid splice

@pytest.fixture(scope="module")
def jamba_no_moe():
    """jamba SMOKE, f32, MoE off: 8 prompt tokens + the 9th, in both
    packages with the same parameters."""
    jc, tc = H.configs("jamba_1_5_large", dtype="float32", moe_every=1000)
    jm, params, tm = H.models(jc, tc)
    toks = np.random.default_rng(3).integers(0, jc.vocab, (1, 9)) \
        .astype(np.int32)
    return jc, tc, jm, params, tm, toks


def test_hybrid_decode_after_prefill_equals_longer_prefill(jamba_no_moe):
    """The port's launcher carries the Mamba states across: decode of the
    9th token after an 8-token prefill == a 9-token prefill."""
    jc, tc, jm, params, tm, toks = jamba_no_moe
    t = torch.from_numpy(toks)
    _, cache = tm.prefill({"tokens": t[:, :8]})
    cache = serve.pad_cache(tm, cache, 1, 16)
    step, _ = tm.decode_step({"tokens": t[:, 8:9]}, cache)
    full, _ = tm.prefill({"tokens": t})
    np.testing.assert_allclose(step.numpy(), full.numpy(), **H.F32_TOL)
    ref, _ = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(step.numpy(), np.asarray(ref), **H.F32_TOL)


def test_reference_launcher_splice_drops_the_mamba_states(jamba_no_moe):
    """The JAX launcher (repro/launch/serve.py) splices only k, v and
    length into init_cache, so its decode restarts every Mamba layer
    from zero state (ROADMAP Queue 3): its logits differ from the
    9-token prefill by far more than the f32 bound, and carrying the
    states across closes the gap."""
    jc, tc, jm, params, tm, toks = jamba_no_moe
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    full, _ = prefill(params, {"tokens": jnp.asarray(toks)})
    _, cache = prefill(params, {"tokens": jnp.asarray(toks[:, :8])})
    launcher = jm.init_cache(1, 16)
    launcher["k"] = launcher["k"].at[:, :, :8].set(cache["k"])
    launcher["v"] = launcher["v"].at[:, :, :8].set(cache["v"])
    launcher["length"] = cache["length"]
    step, _ = decode(params, {"tokens": jnp.asarray(toks[:, 8:9])}, launcher)
    gap = H.max_err(full, step)
    assert gap > 0.1, gap            # 0.142 here, logits up to 4.7
    carried = H.jax_pad(jm, jc, cache, {"tokens": toks[:, :8]}, 16)
    step, _ = decode(params, {"tokens": jnp.asarray(toks[:, 8:9])}, carried)
    assert H.max_err(full, step) <= 2e-4


# ------------------------------------------------------------ guards

def test_serving_entry_points_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = H.configs("yi_6b")[1]
    with pytest.raises(RuntimeError, match="CUDA"):
        T.build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.build_model(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.run(serve.parse_args(["--arch", "yi_6b", "--smoke"]))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "yi_6b", "--smoke"])
    assert T.build_model(cfg, device="cpu").device.type == "cpu"
