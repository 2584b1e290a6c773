"""The units of the port's training slice against the JAX package's, on
the same numpy inputs: AdamW's update and its weight-decay set, the int8
gradient compression (bitwise), the token pipeline (bitwise), the
chunked cross-entropy, the layout conversion back to the reference's
stacked tree; and the decode step past the cache's last slot (both
packages write the last slot again)."""
import pytest

pytest.importorskip("torch")

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as JC
from repro.data import tokens as JT
from repro.models import transformer as JM
from repro.train import grad_compress as JG
from repro.train import optimizer as JO
from repro_torch.data import tokens as TT
from repro_torch.launch import serve
from repro_torch.models import transformer as TM
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.layers import Params
from repro_torch.train import grad_compress as TG
from repro_torch.train import optimizer as TO

import test_torch_lm_common as H
from test_torch_lm_common import _one_torch_thread  # noqa: F401


def shapes_tree(arch):
    """The reference's parameter tree of ``arch``'s SMOKE config as
    ShapeDtypeStructs (no initialisation)."""
    jc, tc = H.configs(arch)
    return jc, tc, jax.eval_shape(JM.build_model(jc).init,
                                  jax.random.PRNGKey(0))


def random_tree(shapes, rng, scale=1.0):
    return jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) * scale).astype(np.float32),
        shapes)


def adam_moments(shapes, rng):
    """m ~ N(0, 1e-4) and v >= m^2, as Adam's moments are (so that
    |m / sqrt(v)| stays of order one)."""
    m = random_tree(shapes, rng, 1e-2)
    v = jax.tree.map(lambda a: (a * a + np.abs(rng.standard_normal(a.shape))
                                * 1e-4).astype(np.float32), m)
    return m, v


def port_named(tc, tree):
    return params_from_jax(tc, tree)


def assert_tree_equal(ref_tree, port_tree, exact=True, **tol):
    ref = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    got = jax.tree.leaves(port_tree)
    assert len(ref) == len(got)
    for (path, r), g in zip(ref, got):
        r, g = H.to_np(r), H.to_np(g)
        assert r.shape == g.shape and r.dtype == g.dtype, \
            jax.tree_util.keystr(path)
        if exact:
            assert np.array_equal(r.view(np.uint8), g.view(np.uint8)), \
                jax.tree_util.keystr(path)
        else:
            np.testing.assert_allclose(g, r, err_msg=jax.tree_util.keystr(
                path), **tol)


# ------------------------------------------------------------ AdamW

@pytest.mark.parametrize("arch,clip", [("stablelm_1_6b", True),
                                       ("stablelm_1_6b", False),
                                       ("whisper_small", True)])
def test_apply_updates_matches_reference(arch, clip):
    """Identical parameters, gradients (global norm above the clip, or
    below it) and state at step 6 (inside the warm-up): new parameters,
    m and v within rtol 1e-6, plus atol 1e-9 for the elements near 0
    (one f32 rounding of the update lr * delta, |lr * delta| < 1e-2; with
    the clip active the global norm, summed in another order, can differ
    by one ulp)."""
    jc, tc, shapes = shapes_tree(arch)
    rng = np.random.default_rng(3)
    params, grads = random_tree(shapes, rng), random_tree(shapes, rng)
    if not clip:
        grads = jax.tree.map(lambda a: a * np.float32(1e-3), grads)
    m, v = adam_moments(shapes, rng)
    cfg = dict(lr=1e-3, warmup_steps=20)
    jstate = {"m": m, "v": v, "step": jnp.asarray(6, jnp.int32)}
    jp, js, jmet = JO.apply_updates(params, grads, jstate,
                                    JO.AdamWConfig(**cfg))
    tp = {n: t.clone() for n, t in port_named(tc, params).items()}
    tstate = {"m": port_named(tc, m), "v": port_named(tc, v),
              "step": torch.tensor(6, dtype=torch.int32)}
    _, ts, tmet = TO.apply_updates(tp, port_named(tc, grads), tstate,
                                   TO.AdamWConfig(**cfg))
    assert (float(jmet["grad_norm"]) > 1.0) == clip
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-6)
    assert float(tmet["lr"]) == float(jmet["lr"])
    assert int(ts["step"]) == int(js["step"]) == 7
    assert ts["step"].dtype == torch.int32
    for ref, got in ((jp, tp), (js["m"], ts["m"]), (js["v"], ts["v"])):
        assert_tree_equal(ref, params_to_jax(tc, got), exact=False,
                          rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_weight_decay_set_equals_reference(arch):
    """A port parameter is decayed iff the reference leaf it comes from
    has two or more dimensions (its blocks' stacked layer axis
    included)."""
    jc, tc, shapes = shapes_tree(arch)
    flags = jax.tree.map(
        lambda s: np.full(s.shape, float(len(s.shape) >= 2), np.float32),
        shapes)
    model = TM.build_model(tc, device="cpu")
    want = {n: bool(t.flatten()[0]) if t.numel() else None
            for n, t in port_named(tc, flags).items()}
    got = {n: TO.decays(n, p) for n, p in model.named_parameters()}
    assert got == want
    assert got["ln_f.scale"] is False
    assert any(got[n] for n in got if n.endswith("ln1.scale"))


def test_bf16_state_dtype():
    """opt_state_dtype bfloat16 (the 398B hybrid's): m and v stored in
    bf16, each within one bf16 rounding of the reference's."""
    jc, tc, shapes = shapes_tree("stablelm_1_6b")
    rng = np.random.default_rng(4)
    params, grads = random_tree(shapes, rng), random_tree(shapes, rng)
    cfg = dict(lr=1e-3, state_dtype="bfloat16")
    jcfg = JO.AdamWConfig(**cfg)
    _, js, _ = JO.apply_updates(params, grads,
                                JO.init_state(params, jcfg), jcfg)
    tp = port_named(tc, params)
    tcfg = TO.AdamWConfig(**cfg)
    _, ts, _ = TO.apply_updates(tp, port_named(tc, grads),
                                TO.init_state(tp, tcfg), tcfg)
    for key in ("m", "v"):
        assert all(t.dtype == torch.bfloat16 for t in ts[key].values())
        assert_tree_equal(js[key], params_to_jax(tc, ts[key]), exact=False,
                          rtol=2 ** -7, atol=0)


# ------------------------------------------------------------ compression

@pytest.mark.parametrize("arch", ["stablelm_1_6b", "jamba_1_5_large"])
def test_compress_grads_bitwise(arch):
    """Three rounds of error feedback: the dequantized gradients and the
    bf16 residuals equal the (jitted) reference's bit for bit (leaf
    sizes that do not divide 256, blocks across two layers' slices)."""
    jc, tc, shapes = shapes_tree(arch)
    rng = np.random.default_rng(5)
    cfg = dict(enabled=True)
    jres = JG.init_residuals(shapes)
    tres = TG.init_residuals(port_named(tc, random_tree(shapes, rng)))
    ref = jax.jit(lambda g, r: JG.compress_grads(
        g, r, JG.GradCompressConfig(**cfg)))
    for _ in range(3):
        grads = jax.tree.map(lambda a: a * 10.0 ** rng.integers(-6, 2),
                             random_tree(shapes, rng))
        jg, jres, jm = ref(grads, jres)
        tg, tres, tm = TG.compress_grads(port_named(tc, grads), tres,
                                         TG.GradCompressConfig(**cfg))
        assert_tree_equal(jg, params_to_jax(tc, tg))
        assert_tree_equal(jres, params_to_jax(tc, tres))
        np.testing.assert_allclose(float(tm["gc_error"]),
                                   float(jm["gc_error"]), rtol=1e-5)


@pytest.mark.parametrize("n,bits", [(1, 8), (255, 8), (256, 8), (1000, 4),
                                    (513, 8), (1 << 18, 8)])
def test_quant_dequant_bitwise(n, bits):
    """Against the reference under jit, as its train step runs it: XLA
    multiplies max|g| by the f32 reciprocal of qmax (eager JAX divides,
    which rounds differently on a few per cent of the blocks)."""
    rng = np.random.default_rng(n)
    g = (rng.standard_normal(n)
         * 10.0 ** rng.integers(-8, 3, n)).astype(np.float32)
    g[::7] = 0.0
    if n > 3:
        g[3] = 127.5 * g[2] / 127.0     # ties on the rounding grid
    ref = np.asarray(jax.jit(lambda x: JG._quant_dequant(x, bits)[0])(
        jnp.asarray(g)))
    got = TG._quant_dequant(torch.from_numpy(g), bits)[0].numpy()
    assert np.array_equal(ref.view(np.uint32), got.view(np.uint32))


def test_compression_disabled_is_the_identity():
    g = {"w": torch.ones(3)}
    r = {"w": torch.zeros(3, dtype=torch.bfloat16)}
    out, res, met = TG.compress_grads(g, r, TG.GradCompressConfig())
    assert out is g and res is r and float(met["gc_error"]) == 0.0


# ------------------------------------------------------------ tokens

@pytest.mark.parametrize("vocab,batch,seq,seed,step", [
    (512, 2, 32, 0, 0), (512, 8, 128, 0, 7), (100352, 8, 128, 3, 41),
    (64, 3, 200, 1, 2)])
def test_global_batch_bitwise(vocab, batch, seq, seed, step):
    jcfg = JT.TokenPipelineConfig(vocab=vocab, batch=batch, seq_len=seq,
                                  seed=seed)
    tcfg = TT.TokenPipelineConfig(vocab=vocab, batch=batch, seq_len=seq,
                                  seed=seed)
    for ref, got in zip(JT.global_batch(jcfg, step),
                        TT.global_batch(tcfg, step)):
        assert got.dtype == ref.dtype == np.int32
        assert np.array_equal(got, ref)
    for host in range(batch if batch <= 4 else 4):
        n_hosts = batch if batch <= 4 else 4
        for ref, got in zip(JT.host_batch(jcfg, step, host, n_hosts),
                            TT.host_batch(tcfg, step, host, n_hosts)):
            assert np.array_equal(got, ref)


# ------------------------------------------------------------ loss

@pytest.mark.parametrize("arch,chunk", [("stablelm_1_6b", 8),
                                        ("qwen1_5_0_5b", 8),
                                        ("stablelm_1_6b", 1024)])
def test_chunked_ce_loss(arch, chunk):
    """chunk = 8 at S = 32 (four chunks), untied and tied embeddings, and
    the default chunk (one chunk), within F32_TOL."""
    jc, tc, shapes = shapes_tree(arch)
    jc = dataclasses.replace(jc, dtype="float32")
    tc = dataclasses.replace(tc, dtype="float32")
    rng = np.random.default_rng(6)
    embed = random_tree(shapes["embed"], rng, 0.1)
    x = rng.standard_normal((H.B, H.S, jc.d_model)).astype(np.float32)
    labels = rng.integers(0, jc.vocab, (H.B, H.S)).astype(np.int32)
    ref = JM.chunked_ce_loss(jc, embed, jnp.asarray(x), jnp.asarray(labels),
                             chunk=chunk)
    got = TM.chunked_ce_loss(tc, Params({k: torch.from_numpy(v)
                                         for k, v in embed.items()}),
                             torch.from_numpy(x), torch.from_numpy(labels),
                             chunk=chunk)
    np.testing.assert_allclose(float(got), float(ref), **H.F32_TOL)


@pytest.mark.parametrize("arch,keys", [("olmoe_1b_7b", {"ce", "aux"}),
                                       ("jamba_1_5_large", {"ce", "aux"}),
                                       ("yi_6b", {"ce", "aux"}),
                                       ("rwkv6_3b", {"ce"}),
                                       ("whisper_small", {"ce"})])
def test_train_loss_metrics_and_aux(arch, keys):
    """train_loss adds 0.01 * the MoE auxiliary loss, summed over the
    layers, and reports {"ce", "aux"} (aux 0 without MoE); RWKV and the
    encoder-decoder report the CE alone, as the reference does (the
    values are held against it in test_torch_train_step.py)."""
    jc, tc = H.configs(arch, dtype="float32")
    tm = TM.build_model(tc, device="cpu")
    rng = np.random.default_rng(7)
    toks = rng.integers(0, tc.vocab, (H.B, H.S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if tc.is_encoder_decoder:
        b["frames"] = rng.standard_normal((H.B, H.S, tc.d_model)).astype(
            np.float32)
    loss, met = tm.train_loss({k: torch.from_numpy(v) for k, v in b.items()})
    assert set(met) == keys and loss.requires_grad is False
    if "aux" in keys:
        assert (float(met["aux"]) > 0) == bool(tc.n_experts)
        np.testing.assert_allclose(
            float(loss), float(met["ce"]) + 0.01 * float(met["aux"]),
            rtol=1e-6)
    else:
        assert float(loss) == float(met["ce"])


def test_serving_keeps_held_casts_and_no_graph():
    """Parameters stay frozen for serving: prefill builds no graph and
    reuses the held bf16 copies; a trainable parameter is cast in the
    graph while grad is enabled and held again under no_grad."""
    tm = TM.build_model(H.configs("yi_6b")[1], device="cpu")
    toks = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    logits, _ = tm.prefill(toks)
    assert not logits.requires_grad
    wq = tm.blocks[0]["attn"]
    held = wq.cast("wq", torch.bfloat16)
    assert wq.cast("wq", torch.bfloat16) is held
    tm.requires_grad_(True)
    cast = wq.cast("wq", torch.bfloat16)
    assert cast is not held and cast.requires_grad
    with torch.no_grad():
        assert wq.cast("wq", torch.bfloat16) is held


# ------------------------------------------------------------ layout

@pytest.mark.parametrize("arch", JC.ARCHS)
def test_params_to_jax_inverts_params_from_jax(arch):
    jc, tc, shapes = shapes_tree(arch)
    tree = random_tree(shapes, np.random.default_rng(8))
    back = params_to_jax(tc, params_from_jax(tc, tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert_tree_equal(tree, back)


def test_params_to_jax_refuses_a_missing_layer():
    jc, tc, shapes = shapes_tree("yi_6b")
    sd = params_from_jax(tc, random_tree(shapes, np.random.default_rng(9)))
    del sd["blocks.1.ln1.scale"]
    with pytest.raises(ValueError, match="blocks.ln1.scale: layers"):
        params_to_jax(tc, sd)


# ------------------------------------------------------------ decode past
# the cache

@pytest.mark.parametrize("arch", ["yi_6b", "whisper_small"])
def test_decode_past_max_len_matches_reference(arch):
    """A cache of max_len 6 after a 4-token prefill: decode steps 3 and 4
    write past the last slot.  The reference clamps the write (and the
    encoder-decoder's position-table read) to slot 5; so does the port,
    and the four steps' logits agree within F32_TOL."""
    jc, tc = H.configs(arch, dtype="float32")
    jm, params, tm = H.models(jc, tc)
    rng = np.random.default_rng(10)
    batch = H.prompt(jc, rng, seq=4)
    if "tokens" in batch:
        batch["tokens"] = batch["tokens"][:, :4]
    steps = H.step_inputs(jc, rng, n=4)
    max_len = 6
    logits, cache = jax.jit(jm.prefill)(params, {k: jnp.asarray(v)
                                                 for k, v in batch.items()})
    cache = H.jax_pad(jm, jc, cache, batch, max_len)
    decode = jax.jit(jm.decode_step)
    ref = []
    for st in steps:
        lg, cache = decode(params, {k: jnp.asarray(v) for k, v in st.items()},
                           cache)
        ref.append(np.asarray(lg))
    assert int(cache["length"]) == 8
    logits, tcache = tm.prefill({k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    tcache = H.port_pad(tm, tc, tcache, batch, max_len)
    for i, st in enumerate(steps):
        lg, tcache = tm.decode_step({k: torch.from_numpy(v)
                                     for k, v in st.items()}, tcache)
        assert np.isfinite(H.to_np(lg)).all()
        np.testing.assert_allclose(H.to_np(lg), ref[i], **H.F32_TOL)
    assert int(tcache["length"]) == 8
    np.testing.assert_allclose(H.to_np(tcache["k"]), np.asarray(cache["k"]),
                               **H.F32_TOL)


def test_serve_runs_past_max_len():
    """The launcher serves past --max-len as the reference's does (the
    steps past the cache overwrite its last slot)."""
    out = serve.run(serve.parse_args([
        "--arch", "yi_6b", "--smoke", "--requests", "2", "--batch", "2",
        "--prompt-len", "120", "--gen-len", "16", "--device", "cpu"]))
    assert out["decoded_tokens"] == 32
    assert all(t.shape == (16,) for t in out["tokens"].values())
    assert all(torch.isfinite(lg).all() for lg in out["last_logits"].values())
