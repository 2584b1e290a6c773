"""One training step of the port (``repro_torch.train.train_step``)
against the JAX package's, per architecture at its SMOKE size: the JAX
package's parameters carried across, the same token-pipeline batch (the
launchers' ``make_batch``, B = 2, S = 32), the launcher's AdamW (lr 1e-3,
20 warm-up steps).

Tolerances (f32 activations): the loss, m and v within ``F32_TOL``; every
gradient leaf within 2e-4 + 2e-4 |ref|; the parameters after the step
within ``F32_TOL`` plus 2 lr_1 (Adam's first update moves each element by
about +-lr_1, so an element whose gradient is near zero in both packages
can move either way).  bf16 activations: each tensor within
0.05 * max(1, max |ref|) (PERF.md section 2's bound).
"""
import pytest

pytest.importorskip("torch")

import jax
import numpy as np
import torch

import repro.configs as JC
from repro.data.tokens import TokenPipelineConfig as JTokens
from repro.launch.train import make_batch as jax_make_batch
from repro.models import transformer as JM
from repro.train import grad_compress as JG
from repro.train import optimizer as JO
from repro.train import train_step as JS
from repro_torch.data.tokens import TokenPipelineConfig as TTokens
from repro_torch.launch.train import make_batch as port_make_batch
from repro_torch.models.convert import load_params, params_to_jax
from repro_torch.train import grad_compress as TG
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TS

import test_torch_lm_common as H
from test_torch_lm_common import _one_torch_thread  # noqa: F401

B, S = 2, 32
OPT = dict(lr=1e-3, warmup_steps=20)       # launch/train.py's AdamW
LR1 = OPT["lr"] / OPT["warmup_steps"]      # the first step's lr
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = 0.05
# bf16 runs: the dense decoder and RWKV (the card's chip_smoke phase 4j
# runs one bf16 model of every family)
FAMILIES = ["stablelm_1_6b", "rwkv6_3b"]


@pytest.fixture(scope="module")
def ref_params():
    """The reference's ``init(PRNGKey(0))`` of an architecture's SMOKE
    config (jitted), made once per module (the activation dtype does not
    change the parameters)."""
    memo = {}

    def get(arch):
        if arch not in memo:
            jc, _ = H.configs(arch)
            memo[arch] = jax.jit(JM.build_model(jc).init)(
                jax.random.PRNGKey(0))
        return memo[arch]
    return get


def models(ref_params, arch, dtype):
    """(configs, the reference model and parameters, a port model holding
    the same parameters) at ``dtype`` activations."""
    jc, tc = H.configs(arch, dtype=dtype)
    params = ref_params(arch)
    tm = H.port_build(tc, device="cpu")
    load_params(tm, jax.tree.map(np.asarray, params))
    return jc, tc, JM.build_model(jc), params, tm


def batches(jc, tc, step):
    """The launchers' batch of ``step`` in each package."""
    jb = jax_make_batch(jc, JTokens(vocab=jc.vocab, batch=B, seq_len=S),
                        step, B, S)
    tb = port_make_batch(tc, TTokens(vocab=tc.vocab, batch=B, seq_len=S),
                         step, B, S, "cpu")
    return jb, tb


def port_tree(tc, named):
    return params_to_jax(tc, {n: t.detach() for n, t in named.items()})


def one_step(ref_params, arch, dtype):
    """Both packages' loss, gradients, parameters and moments after one
    step from the same parameters."""
    jc, tc, jm, params, tm = models(ref_params, arch, dtype)
    jb, tb = batches(jc, tc, 0)
    ocfg = JO.AdamWConfig(**OPT, state_dtype=jc.opt_state_dtype)

    @jax.jit
    def ref_step(p, st, b):
        (loss, _), g = jax.value_and_grad(jm.train_loss, has_aux=True)(p, b)
        newp, newst, _ = JO.apply_updates(p, g, st, ocfg)
        return loss, g, newp, newst

    loss, g, newp, newst = ref_step(params, JO.init_state(params, ocfg), jb)
    ref = {"loss": float(loss), "grads": g, "params": newp,
           "m": newst["m"], "v": newst["v"], "step": int(newst["step"])}

    pcfg = TO.AdamWConfig(**OPT, state_dtype=tc.opt_state_dtype)
    step = TS.make_train_step(tm, pcfg)
    named = dict(tm.named_parameters())
    _, _, grads = TS.value_and_grad(tm, named, tb)
    state, metrics = step(TS.init_train_state(tm, pcfg), tb)
    adam = state["adam"]
    got = {"loss": float(metrics["loss"]), "grads": params_to_jax(tc, grads),
           "params": port_tree(tc, named), "m": params_to_jax(tc, adam["m"]),
           "v": params_to_jax(tc, adam["v"]), "step": int(adam["step"])}
    return ref, got


@pytest.fixture(scope="module")
def steps(ref_params):
    memo = {}

    def get(arch, dtype="float32"):
        if (arch, dtype) not in memo:
            memo[arch, dtype] = one_step(ref_params, arch, dtype)
        return memo[arch, dtype]
    return get


def leaf_pairs(ref_tree, got_tree):
    """(path, ref numpy, port numpy) over the reference's leaves; the port
    tree has the same structure (``params_to_jax``)."""
    ref = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    got = jax.tree.leaves(got_tree)
    assert len(ref) == len(got)
    return [(jax.tree_util.keystr(p), H.to_np(r), H.to_np(g))
            for (p, r), g in zip(ref, got)]


def assert_leaves(ref_tree, got_tree, **tol):
    for path, r, g in leaf_pairs(ref_tree, got_tree):
        assert g.shape == r.shape, path
        np.testing.assert_allclose(g, r, err_msg=path, **tol)


def assert_bf16(ref_tree, got_tree):
    for path, r, g in leaf_pairs(ref_tree, got_tree):
        bound = BF16_TOL * max(1.0, float(np.abs(r).max()))
        assert H.max_err(r, g) <= bound, (path, H.max_err(r, g), bound)


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_loss(steps, arch):
    ref, got = steps(arch)
    np.testing.assert_allclose(got["loss"], ref["loss"], **H.F32_TOL)
    assert got["step"] == ref["step"] == 1


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_gradients(steps, arch):
    ref, got = steps(arch)
    assert_leaves(ref["grads"], got["grads"], **GRAD_TOL)


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_moments(steps, arch):
    ref, got = steps(arch)
    assert_leaves(ref["m"], got["m"], **H.F32_TOL)
    assert_leaves(ref["v"], got["v"], **H.F32_TOL)


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_params_after_step(steps, arch):
    ref, got = steps(arch)
    assert_leaves(ref["params"], got["params"], rtol=H.F32_TOL["rtol"],
                  atol=H.F32_TOL["atol"] + 2 * LR1)


@pytest.mark.parametrize("arch", FAMILIES)
def test_step_bf16(steps, arch):
    ref, got = steps(arch, "bfloat16")
    assert abs(got["loss"] - ref["loss"]) <= BF16_TOL * max(1.0, ref["loss"])
    for key in ("grads", "params", "m", "v"):
        assert_bf16(ref[key], got[key])


def run_steps(ref_params, arch, n, microbatches=1, gc=False):
    """``n`` steps of each package's ``make_train_step`` on the batches of
    steps 0..n-1: per-step losses and gc errors, then the parameters and
    optimizer state."""
    jc, tc, jm, params, tm = models(ref_params, arch, "float32")
    jgc, tgc = JG.GradCompressConfig(enabled=gc), \
        TG.GradCompressConfig(enabled=gc)
    jo = JO.AdamWConfig(**OPT, state_dtype=jc.opt_state_dtype)
    to = TO.AdamWConfig(**OPT, state_dtype=tc.opt_state_dtype)
    jstep = jax.jit(JS.make_train_step(jm, jo, microbatches, jgc))
    jstate = {"adam": JO.init_state(params, jo)}
    if gc:
        jstate["gc_residuals"] = JG.init_residuals(params)
    tstep = TS.make_train_step(tm, to, microbatches, tgc)
    tstate = TS.init_train_state(tm, to, tgc)
    ref, got = {"loss": [], "gc": []}, {"loss": [], "gc": []}
    for i in range(n):
        jb, tb = batches(jc, tc, i)
        params, jstate, jm_ = jstep(params, jstate, jb)
        tstate, tm_ = tstep(tstate, tb)
        ref["loss"].append(float(jm_["loss"]))
        got["loss"].append(float(tm_["loss"]))
        if gc:
            ref["gc"].append(float(jm_["gc_error"]))
            got["gc"].append(float(tm_["gc_error"]))
        if microbatches > 1:
            assert set(tm_) == set(jm_) == {"loss", "grad_norm", "lr"}
    ref.update(params=params, state=jstate)
    got.update(params=port_tree(tc, dict(tm.named_parameters())),
               state=tstate, cfg=tc)
    return ref, got


def test_microbatches(ref_params):
    """microbatches=2 (qwen2-vl splits its (3, B, S) position_ids on axis
    1) against the reference's scan over the same split."""
    ref, got = run_steps(ref_params, "qwen2_vl_7b", 1, microbatches=2)
    np.testing.assert_allclose(got["loss"], ref["loss"], **H.F32_TOL)
    tc = got["cfg"]
    assert_leaves(ref["params"], got["params"], rtol=H.F32_TOL["rtol"],
                  atol=H.F32_TOL["atol"] + 2 * LR1)
    adam = got["state"]["adam"]
    assert_leaves(ref["state"]["adam"]["m"], params_to_jax(tc, adam["m"]),
                  **H.F32_TOL)


def test_microbatched_grads_are_the_mean_of_the_slices():
    """The port's 2-micro-batch gradient is the f32 mean of its own
    gradients on the two halves of the batch."""
    jc, tc = H.configs("qwen2_vl_7b", dtype="float32")
    tm = H.port_build(tc, device="cpu")
    _, tb = batches(jc, tc, 0)
    tm.requires_grad_(True)
    named = dict(tm.named_parameters())
    halves = TS._split_batch(tb, 2)
    assert halves[0]["position_ids"].shape == (3, 1, S)
    assert torch.equal(halves[1]["embeds"], tb["embeds"][1:])
    g0 = TS.value_and_grad(tm, named, halves[0])[2]
    g1 = TS.value_and_grad(tm, named, halves[1])[2]
    # the step's own accumulation, without the optimizer
    state = TS.init_train_state(tm, TO.AdamWConfig(**OPT))
    before = {n: p.detach().clone() for n, p in named.items()}
    TS.make_train_step(tm, TO.AdamWConfig(**dict(OPT, lr=0.0)), 2)(state, tb)
    for n, p in named.items():       # lr 0: no parameter moved
        assert torch.equal(p.detach(), before[n]), n
    mean = {n: (g0[n].float() + g1[n]) / 2 for n in g0}
    m = state["adam"]["m"]
    for n in mean:                   # m_1 = (1 - b1) * clip * g
        gn = TO.global_norm(mean)
        scale = torch.clamp(1.0 / torch.clamp(gn, min=1e-9), max=1.0)
        np.testing.assert_allclose(m[n].numpy(),
                                   (mean[n] * scale * 0.1).numpy(),
                                   rtol=1e-5, atol=1e-9, err_msg=n)


def test_grad_compression_three_steps(ref_params):
    """--grad-compress: three steps with error feedback.  The compressed
    gradient can differ from the reference's by one quantization step
    where the two packages' f32 gradients round to different codes, so
    the parameters get 2 lr_t a step on top of F32_TOL."""
    ref, got = run_steps(ref_params, "stablelm_1_6b", 3, gc=True)
    np.testing.assert_allclose(got["loss"], ref["loss"], **H.F32_TOL)
    np.testing.assert_allclose(got["gc"], ref["gc"], rtol=1e-2)
    lrs = sum(OPT["lr"] * min((i + 1) / OPT["warmup_steps"], 1.0)
              for i in range(3))
    assert_leaves(ref["params"], got["params"], rtol=H.F32_TOL["rtol"],
                  atol=H.F32_TOL["atol"] + 2 * lrs)
    res = got["state"]["gc_residuals"]
    assert all(r.dtype == torch.bfloat16 for r in res.values())
    assert set(got["state"]) == set(ref["state"]) == {"adam",
                                                      "gc_residuals"}
