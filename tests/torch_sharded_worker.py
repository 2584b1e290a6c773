"""Ranks of the sharded-execution tests (``tests/test_torch_sharded.py``):
eight gloo processes on the CPU, started by

    python tests/torch_sharded_worker.py OUT_DIR [REF_CKPT_DIR]

run every case on the meshes (4, 2) ("data", "model") and (2, 2, 2)
("pod", "data", "model") and write what the tests check into OUT_DIR
(``results.json``, ``params_<case>.npz`` and ``grads_<case>.npz``; rank 0
writes).  Nothing here imports JAX: the tests hold these results against
the reference.
"""
import contextlib
import dataclasses
import json
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
sys.path.insert(0, SRC)

WORLD = 8
B, S = 8, 32
OPT = dict(lr=1e-3, warmup_steps=1)     # the reference's sharded test
ARCHS = ["stablelm_1_6b", "qwen1_5_0_5b", "qwen1_5_32b", "yi_6b",
         "qwen2_vl_7b", "whisper_small", "olmoe_1b_7b",
         "llama4_scout_17b_16e", "rwkv6_3b", "jamba_1_5_large"]
# (case, arch, micro-batches)
TRAIN_CASES = [(a, a, 1) for a in ARCHS] + [("stablelm_mb2", ARCHS[0], 2)]
# two steps with clipping active (the global norm is far above it)
CLIP_CASE, CLIP_ARCH, CLIP = "stablelm_clip2", ARCHS[0], 1e-2


def f32_smoke(arch):
    import repro_torch.configs as TC

    return dataclasses.replace(TC.get(arch).SMOKE, dtype="float32")


def batch(cfg, step=0):
    from repro_torch.data.tokens import TokenPipelineConfig
    from repro_torch.launch.train import make_batch

    return make_batch(cfg, TokenPipelineConfig(vocab=cfg.vocab, batch=B,
                                               seq_len=S), step, B, S, "cpu")


@contextlib.contextmanager
def recorded_grads(record):
    """``optimizer.apply_updates`` appends the gradients it is given
    (whole f32 tensors: a DTensor's ``full_tensor()``, which every rank
    calls) to ``record`` before it updates."""
    from repro_torch.train import optimizer as opt

    real = opt.apply_updates

    def apply(params, grads, state, cfg):
        record.append({n: (g.full_tensor() if hasattr(g, "full_tensor")
                           else g).detach().float().clone()
                       for n, g in grads.items()})
        return real(params, grads, state, cfg)

    opt.apply_updates = apply
    try:
        yield
    finally:
        opt.apply_updates = real


def _steps(model, ocfg, microbatches, steps, place=None, rules=None):
    """``steps`` train steps of ``model`` on batches 0, 1, ...: (metrics
    of each step as floats, gradients of each step, final state)."""
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.train_step import init_train_state, \
        make_train_step

    fn = make_train_step(model, ocfg, microbatches)
    state = init_train_state(model, ocfg)
    metrics, grads = [], []
    with recorded_grads(grads), shd.use_rules(rules):
        for i in range(steps):
            b = batch(model.cfg, i)
            state, m = fn(state, place(b) if place else b)
            metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    return metrics, grads, state


def _whole(named):
    return {n: (t.full_tensor() if hasattr(t, "full_tensor") else t)
            .detach().float().numpy() for n, t in named.items()}


def _rel(a, b):
    """max |a - b| over each leaf's max |b| (the largest over leaves)."""
    return max(float(np.abs(a[n] - b[n]).max())
               / max(float(np.abs(b[n]).max()), 1e-30) for n in b)


def train_case(arch, microbatches, mesh, m42, rank, out_dir, res, name,
               steps=1, clip=None):
    """``steps`` steps on the mesh and (rank 0) on one device, from the
    same seed-0 parameters and batches: losses, grad norms, gradients
    (``grads_<name>.npz``: the mesh's and one device's, of the first
    step) and parameters."""
    from repro_torch.launch.train import place_batch
    from repro_torch.models.transformer import build_model
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import optimizer as opt

    cfg = f32_smoke(arch)
    extra = {} if clip is None else {"grad_clip": clip}
    ocfg = opt.AdamWConfig(**OPT, **extra, state_dtype=cfg.opt_state_dtype)
    rules = shd.rules_for_mesh(m42)
    model = build_model(cfg, device="cpu", seed=0)
    shd.distribute_params(model, mesh, rules)
    metrics, grads, state = _steps(
        model, ocfg, microbatches, steps,
        lambda b: place_batch(b, mesh, rules), rules)
    sharded = _whole(dict(model.named_parameters()))
    moments = {k: _whole(state["adam"][k]) for k in ("m", "v")}
    if rank == 0:
        one = build_model(cfg, device="cpu", seed=0)
        m1, g1, state1 = _steps(one, ocfg, microbatches, steps)
        diff = max(float(np.abs(sharded[n] - p.detach().numpy()).max())
                   for n, p in one.named_parameters())
        placed = {n: [str(x) for x in p.placements]
                  for n, p in model.named_parameters()}
        res[name] = {
            "loss": metrics[0]["loss"], "loss_one": m1[0]["loss"],
            "grad_norms": [m["grad_norm"] for m in metrics],
            "grad_norms_one": [m["grad_norm"] for m in m1],
            "param_diff": diff, "placements": placed,
            "moment_rel": {k: _rel(moments[k], _whole(state1["adam"][k]))
                           for k in ("m", "v")}}
        np.savez(os.path.join(out_dir, f"params_{name}.npz"), **sharded)
        np.savez(os.path.join(out_dir, f"grads_{name}.npz"),
                 **{f"mesh:{n}": g.numpy() for n, g in grads[0].items()},
                 **{f"one:{n}": g.numpy() for n, g in g1[0].items()})


def compress_case(mesh, m42, rank, res):
    """``compress_grads`` of DTensor gradients == the one-device function
    on the same whole gradients, bit for bit."""
    from repro_torch.models.transformer import build_model
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import grad_compress as gc

    cfg = f32_smoke("stablelm_1_6b")
    model = build_model(cfg, device="cpu", seed=0)
    named = dict(model.named_parameters())
    gen = torch.Generator().manual_seed(1)
    grads = {n: torch.randn(p.shape, generator=gen) * 1e-2
             for n, p in named.items()}
    resid = {n: (torch.randn(p.shape, generator=gen) * 1e-4)
             .to(torch.bfloat16) for n, p in named.items()}
    specs = shd.param_specs(named, shd.rules_for_mesh(m42))
    g_s = {n: shd.place(t, specs[n], mesh) for n, t in grads.items()}
    r_s = {n: shd.place(t, specs[n], mesh) for n, t in resid.items()}
    cfg_gc = gc.GradCompressConfig(enabled=True)
    new_g, new_r, m = gc.compress_grads(g_s, r_s, cfg_gc)
    full_g = {n: t.full_tensor() for n, t in new_g.items()}
    full_r = {n: t.full_tensor() for n, t in new_r.items()}
    if rank == 0:
        one_g, one_r, m1 = gc.compress_grads(grads, resid, cfg_gc)
        res["compress"] = {
            "grads_equal": all(torch.equal(full_g[n], one_g[n])
                               for n in grads),
            "resid_equal": all(torch.equal(full_r[n], one_r[n])
                               for n in grads),
            "error_equal": bool(torch.equal(m["gc_error"], m1["gc_error"])),
            "sharded_leaves": sum(
                any(p.is_shard() for p in t.placements)
                for t in new_g.values()),
        }


def restore_case(m42, m222, mesh42, mesh222, rank, out_dir, res):
    """A checkpoint of a (4, 2) model, saved as the launcher saves it,
    holds a one-device save's arrays and restores onto (2, 2, 2)."""
    from repro_torch.launch import train as T
    from repro_torch.models.transformer import build_model
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import init_train_state

    cfg = f32_smoke("stablelm_1_6b")
    ocfg = opt.AdamWConfig(**OPT)
    model = build_model(cfg, device="cpu", seed=0)
    shd.distribute_params(model, mesh42, shd.rules_for_mesh(m42))
    state = init_train_state(model, ocfg)
    d = os.path.join(out_dir, "ck_reshape")
    T.save_checkpoint(d, 5, cfg, model, state, 0.0, rank == 0, mesh42)
    template = T.checkpoint_trees(cfg, model, state)
    spec = shd.P(("pod", "data"), "model")
    tgt = {"params": {"embed": {"embedding": shd.NamedSharding(mesh222,
                                                               spec)}}}
    restored, manifest = ckpt.restore(d, template, shardings=tgt)
    w = template["params"]["embed"]["embedding"].numpy()     # (512, 64)
    got = restored["params"]["embed"]["embedding"]
    pod, data, model_i = mesh222.get_coordinate()
    rows = (pod * 2 + data) * 128          # 512 rows over pod x data = 4
    want = w[rows:rows + 128, model_i * 32:(model_i + 1) * 32]
    ok = bool(np.array_equal(got.to_local().numpy(), want))
    full = bool(np.array_equal(got.full_tensor().numpy(), w))
    oks = [None] * WORLD
    dist.all_gather_object(oks, ok)
    if rank == 0:
        # the sharded save wrote what a one-device save of the values does
        d1 = os.path.join(out_dir, "ck_one")
        one = build_model(cfg, device="cpu", seed=0)
        T.save_checkpoint(d1, 5, cfg, one, init_train_state(one, ocfg),
                          0.0, True, None)
        files = []
        for path in (d, d1):
            step_dir = os.path.join(path, "step_00000005")
            with open(os.path.join(step_dir, "manifest.json")) as f:
                man = json.load(f)
            with np.load(os.path.join(step_dir, "arrays.npz")) as z:
                arrays = {k: (z[k].dtype.str, z[k].tobytes())
                          for k in z.files}
            files.append((man["leaves"], man["hash"], man["meta"], arrays))
        res["reshape_files_equal"] = files[0] == files[1]
        res["reshape"] = {
            "placements": [str(p) for p in got.placements],
            "want_placements": [str(p) for p in
                                shd.placements(spec, mesh222)],
            "local_equal_all_ranks": all(oks), "full_equal": full,
            "step": manifest["step"]}


def reference_ckpt_case(ref_dir, mesh, m42, rank, res):
    """A checkpoint the reference wrote (stablelm SMOKE parameters, Adam
    state) restores onto the port's (4, 2) mesh, as ``--resume`` does."""
    from repro_torch.launch import train as T
    from repro_torch.models.convert import params_to_jax
    from repro_torch.models.transformer import build_model
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import init_train_state

    cfg = f32_smoke("stablelm_1_6b")
    model = build_model(cfg, device="cpu", seed=3)
    shd.distribute_params(model, mesh, shd.rules_for_mesh(m42))
    ocfg = opt.AdamWConfig(**OPT)
    model.requires_grad_(True)
    state = init_train_state(model, ocfg)
    restored, manifest = ckpt.restore(ref_dir, T.checkpoint_trees(
        cfg, model, state))
    T.load_trees(cfg, model, state, restored)
    got = params_to_jax(cfg, {n: p.detach().full_tensor()
                              for n, p in model.named_parameters()})
    want = restored["params"]

    def same(a, b):
        if isinstance(a, dict):
            return all(same(a[k], b[k]) for k in a)
        if isinstance(a, list):
            return all(same(x, y) for x, y in zip(a, b))
        return bool(np.array_equal(a.numpy(), np.asarray(b)))

    local_ok = all(
        torch.equal(p.to_local(), shd.place(
            p.detach().full_tensor(), shd.spec_of(p), mesh).to_local())
        for p in model.parameters())
    if rank == 0:
        res["reference_ckpt"] = {
            "params_equal": same(got, want), "step": manifest["step"],
            "local_is_slice": local_ok,
            "sharded": sum(any(q.is_shard() for q in p.placements)
                           for p in model.parameters())}


def act_case(m222, mesh222, rank, res):
    """``act`` on (2, 2, 2) places each kind as its spec says."""
    from torch.distributed.tensor import Replicate

    from repro_torch.parallel import sharding as shd

    rules = shd.rules_for_mesh(m222)
    shapes = {"hidden": (8, 4, 16), "logits": (8, 4, 32),
              "heads": (8, 4, 4, 8), "tokens": (8, 4),
              "cache": (2, 8, 6, 4, 8), "state": (2, 8, 4, 8, 8)}
    out = {}
    gen = torch.Generator().manual_seed(0)
    for kind, shape in shapes.items():
        x = torch.randn(shape, generator=gen)
        xd = shd.place(x, shd.P(), mesh222)
        assert all(isinstance(p, Replicate) for p in xd.placements)
        with shd.use_rules(rules):
            y = shd.act(xd, kind)
        want = shd.placements(shd._ACT_SPECS[kind](rules, shape), mesh222)
        out[kind] = {"placements": [str(p) for p in y.placements],
                     "want": [str(p) for p in want],
                     "values_equal": bool(torch.equal(y.full_tensor(), x))}
    if rank == 0:
        res["act"] = out


def cost_case(rank, res):
    """A SMOKE train step counted on ranks 0-3 as a (2, 2) mesh (the
    dry run's CostMode, as ``sharded_cost`` in the test traces it on a
    fake process group of 4)."""
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    if rank < 4:
        res_local = sharded_cost(mesh)
        if rank == 0:
            res["cost"] = res_local


def sharded_cost(mesh):
    """Ops, flops and collective bytes by kind of the dry run's SMOKE
    train step on ``mesh`` (a (2, 2) DeviceMesh), counted on this rank."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import CellSpec
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.transformer import build_model
    from repro_torch.parallel import sharding as shd

    cfg = f32_smoke("stablelm_1_6b")
    cell = CellSpec("train", S, 4, microbatches=1)
    m = make_test_mesh((2, 2))
    rules = shd.rules_for_mesh(m)
    dev = torch.device("cpu")
    with shd.use_rules(rules), implicit_replication():
        model = build_model(cfg, device=dev)
        shd.distribute_params(model, mesh, rules)
        fn, _ = D.make_step(model, cell, dev, rules.dp_size,
                            D.Placement(m, mesh, rules))
        cost, _, _ = D.trace(fn, flop_counter=False)
    return {"op_counts": dict(cost.op_counts), "flops": cost.flops,
            "dot_flops": cost.dot_flops,
            "coll_breakdown": cost.coll_breakdown}


def run(rank, out_dir, ref_dir, port):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dist.init_process_group("gloo", rank=rank, world_size=WORLD)
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import Mesh, make_test_mesh

    m42 = make_test_mesh((4, 2))
    m222 = Mesh((2, 2, 2), ("pod", "data", "model"))
    mesh42, mesh222 = m42.device_mesh("cpu"), m222.device_mesh("cpu")
    res, errors = {}, {}
    cases = [(name, lambda a=arch, mb=mb, name=name: train_case(
        a, mb, mesh42, m42, rank, out_dir, res, name))
        for name, arch, mb in TRAIN_CASES]
    cases += [
        (CLIP_CASE, lambda: train_case(CLIP_ARCH, 1, mesh42, m42, rank,
                                       out_dir, res, CLIP_CASE, steps=2,
                                       clip=CLIP)),
        ("compress", lambda: compress_case(mesh42, m42, rank, res)),
        ("reshape", lambda: restore_case(m42, m222, mesh42, mesh222, rank,
                                         out_dir, res)),
        ("act", lambda: act_case(m222, mesh222, rank, res)),
        ("cost", lambda: cost_case(rank, res)),
    ]
    if ref_dir:
        cases.append(("reference_ckpt", lambda: reference_ckpt_case(
            ref_dir, mesh42, m42, rank, res)))
    for name, fn in cases:
        try:
            fn()
        except Exception:               # reported, and the next case runs
            errors[name] = traceback.format_exc()[-3000:]
        dist.barrier()
    if rank == 0:
        with open(os.path.join(out_dir, "results.json"), "w") as f:
            json.dump({"results": res, "errors": errors}, f)
    dist.destroy_process_group()


def main():
    out_dir = sys.argv[1]
    ref_dir = sys.argv[2] if len(sys.argv) > 2 else None
    port = 20000 + os.getpid() % 20000
    mp.spawn(run, args=(out_dir, ref_dir, port), nprocs=WORLD)


if __name__ == "__main__":
    main()
