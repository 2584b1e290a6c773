"""Sharded execution of the port's LM scaffold on real ranks: eight gloo
processes on the CPU (``tests/torch_sharded_worker.py``, one spawn for
the whole file) on the meshes (4, 2) ("data", "model") and (2, 2, 2)
("pod", "data", "model"), as the reference's distributed tests run eight
host devices.

* One train step of every SMOKE architecture (f32 activations, B = 8,
  S = 32, the reference's sharded-test AdamW: lr 1e-3, one warm-up
  step) on (4, 2), and stablelm with two micro-batches, held against the
  port's one-device step and the reference's single-device step (its
  jitted ``make_train_step`` from the same parameters, carried across by
  ``convert.params_to_jax``) within the reference's sharded-test
  tolerances: loss 3e-3, every parameter 3e-3.  The reference's own
  sharded step does not run here (jax 0.9.0's ``DuplicateSpecError``,
  ROADMAP Queue 3 item 5).
* Those parameter checks cannot see a wrong gradient (AdamW's first
  update is lr * sign(g), whatever g's size), so the gradients the
  mesh's step applies are held, leaf by leaf, against the one-device
  step's and against ``jax.grad`` of the reference's loss (GRAD_REL of
  each leaf's largest element), and ``grad_norm`` against both
  (NORM_REL).  Two steps with clipping active compare the Adam moments,
  which hold each step's clip factor (MOMENT_REL).  The bounds sit
  between readings on this suite's cases: sound runs reach 8.5e-6
  (gradients), 2.4e-7 (norms) and 1.1e-6 (moments); copies with a fault
  -- ``on_shards`` without the Partial gradient of a replicated input,
  MoE's routing statistics counted on every expert shard, the global
  norm of Partial gradients taken before their sum -- read at least
  0.66, 3.7e-4 and 6.1e-4.
* ``compress_grads`` of DTensor gradients equals the one-device result
  bit for bit.
* A checkpoint saved on (4, 2) holds a one-device save's arrays and
  restores onto (2, 2, 2): every rank's shard is its slice of the saved
  array; a checkpoint the reference wrote restores onto the port's
  (4, 2) model.
* ``act`` places hidden states, logits, heads, tokens, caches and states
  as ``placements(_ACT_SPECS[kind])`` on (2, 2, 2).
* The dry run's count of a SMOKE train step on a fake process group of
  4 equals the count of the same step on four real gloo ranks (a (2, 2)
  mesh): ops, flops and collective bytes by kind, both on "cpu" meshes.
"""
import pytest

pytest.importorskip("torch")

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import torch

import repro.configs as JC
from repro.data.tokens import TokenPipelineConfig as JTokens
from repro.launch.train import make_batch as jax_make_batch
from repro.models import transformer as JM
from repro.train import checkpoint as JCK
from repro.train import optimizer as JO
from repro.train import train_step as JS
from repro_torch.models.convert import params_to_jax
from repro_torch.models.transformer import build_model

import torch_sharded_worker as W
from test_torch_lm_common import _one_torch_thread  # noqa: F401

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(TESTS), "src")
TIMEOUT_S = 600
TOL = 3e-3                       # tests/test_distributed_ft.py's
GRAD_REL = 1e-4                  # module docstring: the readings
NORM_REL = 1e-5
MOMENT_REL = 1e-4
KINDS = ["hidden", "logits", "heads", "tokens", "cache", "state"]

FAKE_COST = """
import json, sys
sys.path[:0] = [{tests!r}, {src!r}]
import torch
torch.set_num_threads(1)
from repro_torch.launch.mesh import init_fake, make_test_mesh
import torch_sharded_worker as W
init_fake(4)
print("COST" + json.dumps(W.sharded_cost(
    make_test_mesh((2, 2)).device_mesh("cpu"))))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([SRC, TESTS])
    env.pop("JAX_PLATFORMS", None)
    return env


def _reference_checkpoint(d):
    """A stablelm SMOKE checkpoint written by the reference: parameters of
    seed 5 (carried across), Adam moments made from them, step 7."""
    tc = W.f32_smoke("stablelm_1_6b")
    model = build_model(tc, device="cpu", seed=5)
    tree = params_to_jax(tc, {n: p.detach()
                              for n, p in model.named_parameters()})
    params = jax.tree.map(lambda t: np.asarray(t.numpy()), tree)
    adam = {"m": jax.tree.map(lambda a: a * 0.1, params),
            "v": jax.tree.map(lambda a: a * a, params),
            "step": np.int32(7)}
    JCK.save(d, 7, {"params": params, "opt": {"adam": adam}})
    return params


def _reference_step(arch, microbatches):
    """The reference's jitted single-device step from the port's seed-0
    parameters, and ``jax.grad`` of its loss on them (the mean over the
    micro-batches, as its step takes it): (loss, grad norm, parameters
    after the step, gradients)."""
    jc = dataclasses.replace(JC.get(arch).SMOKE, dtype="float32")
    tc = W.f32_smoke(arch)
    tm = build_model(tc, device="cpu", seed=0)
    params = jax.tree.map(lambda t: jax.numpy.asarray(t.numpy()),
                          params_to_jax(tc, {n: p.detach() for n, p
                                             in tm.named_parameters()}))
    ocfg = JO.AdamWConfig(**W.OPT, state_dtype=jc.opt_state_dtype)
    batch = jax_make_batch(jc, JTokens(vocab=jc.vocab, batch=W.B,
                                       seq_len=W.S), 0, W.B, W.S)
    model = JM.build_model(jc)
    step = JS.make_train_step(model, ocfg, microbatches)
    grad = jax.grad(lambda p, b: model.train_loss(p, b)[0])

    def both(p, s, b):
        mbs = JS._split_batch(b, microbatches)
        g = [grad(p, jax.tree.map(lambda x, i=i: x[i], mbs))
             for i in range(microbatches)]
        return step(p, s, b), jax.tree.map(
            lambda *x: sum(x) / microbatches, *g)

    (new, _, metrics), g = jax.jit(both)(
        params, {"adam": JO.init_state(params, ocfg)}, batch)
    return (float(metrics["loss"]), float(metrics["grad_norm"]),
            jax.tree.map(np.asarray, new), jax.tree.map(np.asarray, g))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results, the fake trace's count, the reference steps and
    the reference checkpoint's parameters (the ranks, the fake trace and
    the reference steps run at the same time)."""
    out = str(tmp_path_factory.mktemp("sharded"))
    ref_dir = os.path.join(out, "ref_ckpt")
    ref_params = _reference_checkpoint(ref_dir)
    log = open(os.path.join(out, "ranks.log"), "w")
    ranks = subprocess.Popen(
        [sys.executable, os.path.join(TESTS, "torch_sharded_worker.py"),
         out, ref_dir], env=_env(), stdout=log, stderr=subprocess.STDOUT)
    fake = subprocess.Popen(
        [sys.executable, "-c", FAKE_COST.format(tests=TESTS, src=SRC)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        refs = {name: _reference_step(arch, mb)
                for name, arch, mb in W.TRAIN_CASES}
        fake_out, _ = fake.communicate(timeout=TIMEOUT_S)
        rc = ranks.wait(timeout=TIMEOUT_S)
    finally:
        for p in (ranks, fake):
            if p.poll() is None:
                p.kill()
        log.close()
    with open(os.path.join(out, "ranks.log")) as f:
        ranks_log = f.read()
    assert rc == 0, ranks_log[-4000:]
    with open(os.path.join(out, "results.json")) as f:
        got = json.load(f)
    line = [s for s in fake_out.splitlines() if s.startswith("COST")]
    assert line, fake_out[-4000:]
    return {"out": out, "results": got["results"], "errors": got["errors"],
            "fake": json.loads(line[0][4:]), "refs": refs,
            "ref_params": ref_params}


def result(run, name):
    assert name not in run["errors"], run["errors"][name]
    return run["results"][name]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _leaves(t, path + (i,))
    else:
        yield path, tree


CASES = [name for name, _, _ in W.TRAIN_CASES]
ARCH_OF = {name: arch for name, arch, _ in W.TRAIN_CASES}


def _grads(run, case):
    """(the mesh's, one device's) gradients of the case's first step, by
    the port's parameter names."""
    with np.load(os.path.join(run["out"], f"grads_{case}.npz")) as z:
        return tuple({k.split(":", 1)[1]: z[k] for k in z.files
                      if k.startswith(side + ":")} for side in ("mesh", "one"))


def _rel_err(got, want):
    """Each leaf's max |got - want| over its max |want|, the largest (a
    leaf the loss does not use must be zero on both)."""
    worst = 0.0
    for k in want:
        d = float(np.abs(got[k] - want[k]).max())
        top = float(np.abs(want[k]).max())
        worst = max(worst, d / top if top else (0.0 if d == 0 else np.inf))
    return worst


@pytest.mark.parametrize("case", CASES)
def test_sharded_step_equals_one_device_step(run, case):
    r = result(run, case)
    assert abs(r["loss"] - r["loss_one"]) < TOL, r
    assert r["param_diff"] <= TOL, r
    # the parameters really were sharded, on both axes somewhere
    placed = [p for pl in r["placements"].values() for p in pl]
    assert any(p.startswith("S") for p in placed[0::2]), r["placements"]
    assert any(p.startswith("S") for p in placed[1::2]), r["placements"]


@pytest.mark.parametrize("case", CASES)
def test_sharded_step_equals_reference_step(run, case):
    r = result(run, case)
    ref_loss, _, ref_params, _ = run["refs"][case]
    assert abs(r["loss"] - ref_loss) < TOL, (r["loss"], ref_loss)
    with np.load(os.path.join(run["out"], f"params_{case}.npz")) as z:
        got = params_to_jax(W.f32_smoke(ARCH_OF[case]),
                            {n: torch.from_numpy(z[n]) for n in z.files})
    want = dict(_leaves(ref_params))
    pairs = list(_leaves(got))
    assert {p for p, _ in pairs} == set(want)
    for path, leaf in pairs:
        d = np.abs(leaf.numpy() - want[path].astype(np.float32)).max()
        assert d <= TOL, (path, d)


@pytest.mark.parametrize("case", CASES)
def test_sharded_grads_equal_one_device_grads(run, case):
    """The gradients the mesh's step applies (every leaf, whole) against
    the one-device step's, each leaf within GRAD_REL of its largest
    element."""
    result(run, case)
    mesh, one = _grads(run, case)
    assert set(mesh) == set(one)
    assert _rel_err(mesh, one) <= GRAD_REL


@pytest.mark.parametrize("case", CASES)
def test_sharded_grads_equal_reference_grads(run, case):
    """The mesh's gradients against ``jax.grad`` of the reference's loss
    on the same parameters and batch."""
    result(run, case)
    mesh, _ = _grads(run, case)
    got = dict(_leaves(params_to_jax(
        W.f32_smoke(ARCH_OF[case]),
        {n: torch.from_numpy(g) for n, g in mesh.items()})))
    want = {p: np.asarray(g, np.float32)
            for p, g in _leaves(run["refs"][case][3])}
    assert set(got) == set(want)
    assert _rel_err({p: g.numpy() for p, g in got.items()}, want) \
        <= GRAD_REL


@pytest.mark.parametrize("case", CASES + [W.CLIP_CASE])
def test_sharded_grad_norm_equals_one_device(run, case):
    """``grad_norm`` of every step on the mesh against one device's (and,
    for the one-step cases, the reference's)."""
    r = result(run, case)
    for got, want in zip(r["grad_norms"], r["grad_norms_one"],
                         strict=True):
        assert abs(got - want) <= NORM_REL * want, r["grad_norms"]
    if case in ARCH_OF:
        ref = run["refs"][case][1]
        assert abs(r["grad_norms"][0] - ref) <= NORM_REL * ref, (
            r["grad_norms"], ref)


def test_clipped_steps_equal_one_device(run):
    """Two steps with clipping active on both: the moments after them
    hold each step's clip factor (Adam's first update does not)."""
    r = result(run, W.CLIP_CASE)
    assert len(r["grad_norms"]) == 2
    assert min(r["grad_norms_one"]) > 10 * W.CLIP, r["grad_norms_one"]
    assert r["moment_rel"]["m"] <= MOMENT_REL, r["moment_rel"]
    assert r["moment_rel"]["v"] <= MOMENT_REL, r["moment_rel"]
    assert r["param_diff"] <= TOL, r


def test_compress_grads_on_a_mesh_is_bitwise(run):
    r = result(run, "compress")
    assert r["grads_equal"] and r["resid_equal"] and r["error_equal"], r
    assert r["sharded_leaves"] > 0


def test_mesh_reshape_restore(run):
    r = result(run, "reshape")
    assert r["placements"] == r["want_placements"] == ["S(0)", "S(0)",
                                                       "S(1)"]
    assert r["local_equal_all_ranks"] and r["full_equal"], r
    assert r["step"] == 5


def test_sharded_save_writes_the_one_device_bytes(run):
    """Rank 0's save of a (4, 2) DTensor: the same arrays (dtype and
    bytes), leaf index and data hash as a one-device save."""
    result(run, "reshape")
    assert run["results"]["reshape_files_equal"] is True


def test_reference_checkpoint_restores_onto_the_mesh(run):
    r = result(run, "reference_ckpt")
    assert r["params_equal"] and r["local_is_slice"], r
    assert r["step"] == 7 and r["sharded"] > 0


@pytest.mark.parametrize("kind", KINDS)
def test_act_places_each_kind_as_its_spec(run, kind):
    r = result(run, "act")[kind]
    assert r["placements"] == r["want"], r
    assert r["values_equal"]
    assert any(p != "R" for p in r["placements"])


def test_fake_trace_equals_real_ranks(run):
    real, fake = result(run, "cost"), run["fake"]
    assert real["op_counts"] == fake["op_counts"]
    assert real["flops"] == fake["flops"]
    assert real["dot_flops"] == fake["dot_flops"] > 0
    assert real["coll_breakdown"] == fake["coll_breakdown"]
    assert set(real["coll_breakdown"]) >= {"all-gather", "all-reduce",
                                           "reduce-scatter"}
