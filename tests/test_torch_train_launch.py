"""The port's training launcher (``repro_torch.launch.train``) and its
checkpoints: resume equals an uninterrupted run, checkpoints cross
between the two packages bitwise in both directions (the reference's
on-disk format and stacked layout), both packages refuse a bf16 leaf
with the same TypeError, a ``--mesh`` of more devices than the process
group's ranks raises ValueError (``1x1`` trains as without it; the
sharded launch is ``tests/test_torch_sharded_launch.py``) and the entry
points need CUDA unless given the CPU."""
import pytest

pytest.importorskip("torch")

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import transformer as JM
from repro.train import checkpoint as JC
from repro.train import optimizer as JO
from repro_torch.launch import train
from repro_torch.train import checkpoint as TC
from repro_torch.train import optimizer as TO
from repro_torch.train.train_step import init_train_state

import test_torch_lm_common as H
from test_torch_lm_common import _one_torch_thread  # noqa: F401

SMOKE = ["--smoke", "--device", "cpu", "--log-every", "1"]


def run(tmp_path, *argv):
    return train.run(train.parse_args(list(argv) + SMOKE))


def test_resume_gives_the_uninterrupted_losses(tmp_path):
    """--steps 6 --ckpt-every 3 in one run, against --steps 3 then
    --resume to 6: the same six losses, bit for bit, and the same final
    checkpoint."""
    full = run(tmp_path, "--steps", "6", "--ckpt-every", "3",
               "--ckpt-dir", str(tmp_path / "a"))
    assert TC.latest_step(str(tmp_path / "a")) == 6
    first = run(tmp_path, "--steps", "3", "--ckpt-every", "3",
                "--ckpt-dir", str(tmp_path / "b"))
    rest = run(tmp_path, "--steps", "6", "--ckpt-every", "3",
               "--ckpt-dir", str(tmp_path / "b"), "--resume")
    assert rest["start_step"] == 3
    assert first["losses"] + rest["losses"] == full["losses"]
    assert full["losses"][-1] < full["losses"][0]
    a = np.load(tmp_path / "a" / "step_00000006" / "arrays.npz")
    b = np.load(tmp_path / "b" / "step_00000006" / "arrays.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert np.array_equal(a[k], b[k]), k


def reference_templates(arch):
    """The reference's {"params", "opt"} trees as ShapeDtypeStructs."""
    jc, tc = H.configs(arch)
    jm = JM.build_model(jc)
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    opt = {"adam": jax.eval_shape(
        lambda p: JO.init_state(p, JO.AdamWConfig()), params)}
    return jc, tc, {"params": params, "opt": opt}


@pytest.mark.parametrize("arch,lossy", [("stablelm_1_6b", None),
                                        ("jamba_1_5_large", None),
                                        ("whisper_small", 1e-3)])
def test_port_checkpoint_restores_in_the_reference(tmp_path, arch, lossy):
    """Two port steps saved by the port (stacked layout, the LATEST
    pointer, the manifest) restore with the reference's ``restore`` into
    its own templates, equal to the port's tensors bit for bit (with
    ``lossy_rel_eb``: equal to the port's own lossy restore)."""
    jc, tc, templates = reference_templates(arch)
    out = run(tmp_path, "--arch", arch, "--steps", "2")
    trees = train.checkpoint_trees(tc, out["model"], out["state"])
    d = str(tmp_path / "ck")
    TC.save(d, 2, trees, meta={"arch": tc.name}, lossy_rel_eb=lossy)
    assert JC.latest_step(d) == 2
    ref, rman = JC.restore(d, templates)
    got, tman = TC.restore(d, trees)
    assert rman == tman and rman["meta"] == {"arch": tc.name}
    ref_l = jax.tree_util.tree_flatten_with_path(ref)[0]
    want = jax.tree.leaves(trees if lossy is None else got)
    assert len(ref_l) == len(want)
    for (path, r), w in zip(ref_l, want):
        w = H.to_np(w)
        assert r.dtype == w.dtype and r.shape == w.shape, path
        assert np.array_equal(r, w), jax.tree_util.keystr(path)
    assert int(ref["opt"]["adam"]["step"]) == 2
    if lossy:
        assert any("lossy_q" in e for e in tman["leaves"].values())


@pytest.mark.parametrize("arch", ["yi_6b", "jamba_1_5_large"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, arch):
    """A checkpoint the reference saves (random trees of its layout, step
    7) resumes the port's launcher: its parameters, m, v and step equal
    the saved arrays bit for bit, and training goes on from step 7."""
    jc, tc, templates = reference_templates(arch)
    rng = np.random.default_rng(11)
    trees = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype)
        if s.shape else np.asarray(7, s.dtype), templates)
    d = str(tmp_path / "ck")
    JC.save(d, 7, trees, meta={"arch": jc.name})
    model = H.port_build(tc, device="cpu")
    state = init_train_state(model, TO.AdamWConfig())
    restored, _ = TC.restore(d, train.checkpoint_trees(tc, model, state))
    train.load_trees(tc, model, state, restored)
    got = train.checkpoint_trees(tc, model, state)
    for (path, r), g in zip(jax.tree_util.tree_flatten_with_path(trees)[0],
                            jax.tree.leaves(got)):
        assert np.array_equal(np.asarray(r), H.to_np(g)), \
            jax.tree_util.keystr(path)
    out = run(tmp_path, "--arch", arch, "--steps", "8", "--ckpt-dir", d,
              "--resume")
    assert out["start_step"] == 7 and len(out["losses"]) == 1
    assert int(out["state"]["adam"]["step"]) == 8


def test_bf16_leaf_raises_the_references_type_error(tmp_path):
    """Neither package can save a bf16 leaf (the reference's fault, kept
    as it is): the same TypeError message, no step directory, no
    LATEST."""
    msgs = []
    for pkg, leaf in ((JC, jnp.zeros((4,), jnp.bfloat16)),
                      (TC, torch.zeros(4, dtype=torch.bfloat16))):
        d = tmp_path / pkg.__name__
        with pytest.raises(TypeError) as err:
            pkg.save(str(d), 1, {"params": {"w": np.ones(3, np.float32)},
                                 "opt": {"gc_residuals": {"r": leaf}}})
        msgs.append(str(err.value))
        assert not (d / "LATEST").exists()
        assert not any(p.name.startswith("step_") for p in d.iterdir())
    assert msgs[0] == msgs[1] == \
        "non-numeric checkpoint leaf gc_residuals/r: bfloat16"


def test_grad_compress_with_a_checkpoint_dir_raises(tmp_path):
    """--grad-compress keeps bf16 residuals, which the checkpoint format
    cannot hold: the launcher raises at its first save, as the
    reference's does."""
    with pytest.raises(TypeError, match="non-numeric checkpoint leaf "
                       "gc_residuals/blocks/attn/wk: bfloat16"):
        run(tmp_path, "--steps", "2", "--ckpt-every", "1", "--ckpt-dir",
            str(tmp_path / "ck"), "--grad-compress")


def test_gc_keeps_the_newest_steps(tmp_path):
    d = str(tmp_path / "ck")
    for step in (1, 2, 3, 4):
        TC.save(d, step, {"params": {"w": np.full(3, step, np.float32)}},
                keep=2)
    assert sorted(os.listdir(d)) == ["LATEST", "step_00000003",
                                     "step_00000004"]
    assert JC.latest_step(d) == TC.latest_step(d) == 4
    with open(os.path.join(d, "step_00000004", "manifest.json")) as f:
        assert json.load(f)["step"] == 4
    with pytest.raises(TC.CheckpointError, match="no checkpoint"):
        TC.restore(str(tmp_path / "empty"), {})
    with pytest.raises(TC.CheckpointError, match="shape"):
        TC.restore(d, {"params": {"w": np.zeros(4)}})


@pytest.mark.parametrize("rel_eb", [1e-3, 1e-2])
def test_lossy_encode_equals_the_references(rel_eb):
    rng = np.random.default_rng(12)
    for arr in (rng.standard_normal(4096).astype(np.float32),
                rng.standard_normal((64, 64)), np.zeros(2048, np.float32),
                np.ones(100, np.float32), np.arange(2048)):
        ref, got = JC._lossy_encode(arr, rel_eb), TC._lossy_encode(arr,
                                                                   rel_eb)
        if ref is None:
            assert got is None
        else:
            assert np.array_equal(ref[0], got[0]) and ref[1] == got[1]


def test_main_prints_the_train_lines(capsys):
    assert train.main(["--steps", "2"] + SMOKE) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[train] step     0 loss ")
    assert out[1].startswith("[train] step     1 loss ")
    assert out[-1].startswith("[train] done: loss ")
    assert out[-1].endswith("0 straggler events")


def test_mesh_is_refused(tmp_path, monkeypatch):
    """A mesh whose size is not the world size raises ValueError: without
    a process group (not started by torch.distributed.run), and with one
    of another size."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for mesh in ("2x2", "2x1", "2x2x2"):
        with pytest.raises(ValueError, match="torch.distributed.run"):
            run(tmp_path, "--mesh", mesh)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 4)
    with pytest.raises(ValueError, match="torch.distributed.run"):
        train.parse_mesh("2x4").device_mesh("cpu")


def test_mesh_1x1_trains_as_without(tmp_path):
    plain = run(tmp_path, "--steps", "2")
    meshed = run(tmp_path, "--steps", "2", "--mesh", "1x1")
    assert meshed["losses"] == plain["losses"]
    assert train.parse_mesh("1x1").shape == {"data": 1, "model": 1}


def test_training_entry_points_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.run(train.parse_args(["--smoke"]))
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.run(train.parse_args(["--smoke", "--device", "cuda"]))
