"""The training launcher on a mesh: ``python -m torch.distributed.run
--nproc-per-node 4 -m repro_torch.launch.train --smoke --mesh 2x2
--device cpu`` (four gloo ranks) gives the one-device launcher's losses
within the reference's sharded-test tolerance (3e-3; the SMOKE model's
bf16 activations), only rank 0 logs, rank 0's checkpoint restores in the
reference, and ``--resume`` on the mesh continues the step sequence."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from repro.train import checkpoint as JC
from repro_torch.launch import train
from repro_torch.train import checkpoint as TC

from test_torch_lm_common import _one_torch_thread  # noqa: F401

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
TOL = 3e-3
ARGS = ["--smoke", "--device", "cpu", "--log-every", "1", "--ckpt-every",
        "2"]


def launch(*argv):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "4", "--master-port", str(21000 + os.getpid() % 20000), "-m",
         "repro_torch.launch.train", "--mesh", "2x2", *ARGS, *argv],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


def losses(out):
    return {int(s): float(v) for s, v in
            re.findall(r"\[train\] step\s+(\d+) loss (\d+\.\d+)", out)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ck"))
    first = launch("--steps", "2", "--ckpt-dir", d)
    resumed = launch("--steps", "4", "--ckpt-dir", d, "--resume")
    one = train.run(train.parse_args(ARGS + ["--steps", "4"]))
    return {"dir": d, "first": first, "resumed": resumed,
            "one": dict(enumerate(one["losses"])), "model": one["model"]}


def test_mesh_losses_equal_one_device(runs):
    got = losses(runs["first"])
    assert sorted(got) == [0, 1]
    for step, loss in got.items():
        assert abs(loss - runs["one"][step]) < TOL, (step, loss)


def test_only_rank_0_logs(runs):
    out = runs["first"]
    assert out.count("[train] step     0 loss") == 1
    assert out.count("[train] done:") == 1


def test_resume_on_the_mesh_continues_the_steps(runs):
    out = runs["resumed"]
    assert "[train] resumed from step 2" in out
    got = losses(out)
    assert sorted(got) == [2, 3]
    for step, loss in got.items():
        assert abs(loss - runs["one"][step]) < TOL, (step, loss)


def test_mesh_checkpoint_restores_in_the_reference(runs):
    d = runs["dir"]
    assert TC.latest_step(d) == 4 and JC.latest_step(d) == 4
    model = runs["model"]
    state = train.init_train_state(model, train.opt.AdamWConfig())
    trees = train.checkpoint_trees(model.cfg, model, state)
    ref, _ = JC.restore(d, trees)
    port, _ = TC.restore(d, trees)
    flat_r = dict(TC._flatten(ref))
    flat_p = dict(TC._flatten(port))
    assert flat_r.keys() == flat_p.keys() and len(flat_r) > 10
    for k in flat_r:
        np.testing.assert_array_equal(flat_r[k], flat_p[k])
