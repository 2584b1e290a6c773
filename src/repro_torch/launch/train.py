"""End-to-end training launcher with checkpoint/restart and straggler
mitigation (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm_1_6b \
        --smoke --steps 200 --ckpt-dir /tmp/ckpt [--resume] \
        [--grad-compress] [--device cpu]

    # sharded, one process per rank (NCCL on the cards, gloo on the CPU)
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 8 \
        -m repro_torch.launch.train --smoke --mesh 4x2 [--device cpu]

Same flags and defaults as the JAX launcher, plus ``--device`` (the CUDA
device unless ``--device cpu`` is given).  ``--mesh 1x1`` trains under the
sharding rules of the one device's mesh, as without it.  A larger mesh
("AxB": ("data", "model"); "PxAxB" adds "pod") trains over as many ranks,
started by ``torch.distributed.run``: every parameter and optimizer
moment is a DTensor placed by ``param_specs``, each batch is placed
``P(dp)``, and only rank 0 logs and writes checkpoints (every rank
gathers them).  A mesh whose size is not the world size raises
ValueError.

Fault-tolerance contract:
  * checkpoints are atomic (tmp + rename + LATEST pointer) and saved
    every ``--ckpt-every`` steps in the JAX package's format (its
    stacked layout, ``convert.params_to_jax``); ``--resume`` restarts
    from LATEST, including the data-pipeline position (stateless batches
    keyed on step), from a checkpoint of either package.
  * straggler mitigation: per-step deadline = ``--deadline-factor`` x
    rolling median step time; a breach logs a straggler event (counted
    and reported: one device has no peers to preempt).
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np
import torch

from .. import configs as C
from ..core.compressor import resolve_device
from ..data.tokens import TokenPipelineConfig, global_batch
from ..launch.mesh import make_test_mesh
from ..models.convert import params_from_jax, params_to_jax
from ..models.transformer import build_model
from ..parallel import sharding as shd
from ..train import checkpoint as ckpt
from ..train import optimizer as opt
from ..train.grad_compress import GradCompressConfig
from ..train.train_step import init_train_state, make_train_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm_1_6b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--deadline-factor", type=float, default=3.0)
    ap.add_argument("--mesh", default="",
                    help="e.g. 4x2 (data x model) or 2x2x2 (pod x data x "
                         "model); more than one device needs as many "
                         "ranks (torch.distributed.run)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    return ap.parse_args(argv)


def parse_mesh(s):
    """``--mesh`` "AxB" ("data", "model") or "PxAxB" (with "pod") -> a
    Mesh; None when empty."""
    if not s:
        return None
    dims = tuple(int(x) for x in s.split("x"))
    names = ("data", "model")[: len(dims)] if len(dims) <= 2 else (
        "pod", "data", "model")
    return make_test_mesh(dims, names)


def make_batch(cfg, tp_cfg, step, batch, seq, device):
    """The step's batch on ``device``: the token pipeline's tokens and
    labels, seeded embeddings and M-RoPE positions for the embedding-input
    family, frames and the first 64 tokens for the encoder-decoder."""
    tokens, labels = global_batch(tp_cfg, step)
    out = {"tokens": torch.from_numpy(tokens),
           "labels": torch.from_numpy(labels)}
    if cfg.embedding_inputs:
        rng = np.random.default_rng(step)
        emb = rng.normal(0, 1, (batch, seq, cfg.d_model)).astype(np.float32)
        out = {
            "embeds": torch.from_numpy(emb).to(torch.bfloat16),
            "position_ids": torch.arange(seq, dtype=torch.int32)[None, None]
            .expand(3, batch, seq),
            "labels": out["labels"],
        }
    if cfg.is_encoder_decoder:
        rng = np.random.default_rng(step)
        frames = rng.normal(0, 1, (batch, seq, cfg.d_model))
        out = {
            "frames": torch.from_numpy(frames.astype(np.float32)),
            "tokens": out["tokens"][:, :64],
            "labels": out["labels"][:, :64],
        }
    return {k: v.to(device) for k, v in out.items()}


def place_batch(batch, mesh, rules) -> dict:
    """The global ``batch`` (the same on every rank) as DTensors on the
    device mesh ``mesh``: batch axis over the data axes (``P(dp)``;
    position_ids (3, B, S) on its axis 1)."""
    return {k: shd.place(v, shd.P(None, rules.dp) if k == "position_ids"
                         else shd.P(rules.dp), mesh)
            for k, v in batch.items()}


def _host(t):
    t = t.detach()
    return (t.full_tensor() if shd.is_sharded(t) else t).cpu()


def checkpoint_trees(cfg, model, state) -> dict:
    """{"params", "opt"} in the reference's layout, on the host (sharded
    tensors gathered: every rank calls it)."""

    def tree(named):
        return params_to_jax(cfg, {n: _host(t) for n, t in named.items()})

    adam = state["adam"]
    opt_tree = {"adam": {"m": tree(adam["m"]), "v": tree(adam["v"]),
                         "step": adam["step"].cpu()}}
    if "gc_residuals" in state:
        opt_tree["gc_residuals"] = tree(state["gc_residuals"])
    return {"params": tree(dict(model.named_parameters())), "opt": opt_tree}


@torch.no_grad()
def load_trees(cfg, model, state, trees):
    """Copy restored reference-layout ``trees`` into ``model``'s
    parameters and ``state``'s tensors."""

    def into(named, tree):
        sd = params_from_jax(cfg, tree)
        if set(sd) != set(named):
            raise ckpt.CheckpointError(
                f"checkpoint leaves {sorted(set(sd) ^ set(named))[:4]} do "
                "not match the model")
        for n, t in named.items():
            if shd.is_sharded(t):      # this rank's slice of the array
                t.to_local().copy_(shd.place(
                    sd[n], shd.spec_of(t), t.device_mesh).to_local())
            else:
                t.copy_(sd[n])

    into(dict(model.named_parameters()), trees["params"])
    adam, src = state["adam"], trees["opt"]["adam"]
    into(adam["m"], src["m"])
    into(adam["v"], src["v"])
    adam["step"].copy_(torch.from_numpy(np.asarray(src["step"])))
    if "gc_residuals" in state:
        into(state["gc_residuals"], trees["opt"]["gc_residuals"])


def _sharded_device(mesh, device):
    """This rank's device for ``mesh`` (more than one device): the
    process group of a ``torch.distributed.run`` launch, started here if
    none is running; ValueError unless its world size is the mesh's."""
    import os

    import torch.distributed as dist

    from .mesh import init_distributed

    if not dist.is_initialized() and "WORLD_SIZE" not in os.environ:
        raise ValueError(
            f"--mesh {'x'.join(map(str, mesh.axis_sizes))} needs "
            f"{mesh.size} ranks: start them with python -m "
            f"torch.distributed.run --nproc-per-node {mesh.size} -m "
            "repro_torch.launch.train ...")
    kind = resolve_device(device).type
    dev = init_distributed(kind)
    return dev, mesh.device_mesh(kind)


def save_checkpoint(directory, step, cfg, model, state, loss, lead,
                    dmesh):
    """The checkpoint of ``model`` and ``state`` at ``step``.  On a mesh
    (``dmesh``) every rank calls it: each gathers the trees, rank 0
    (``lead``) writes them -- the same bytes as a one-device save of the
    same values -- and the others wait for it at a barrier."""
    trees = checkpoint_trees(cfg, model, state)
    if lead:
        ckpt.save(directory, step, trees,
                  meta={"arch": cfg.name, "loss": loss})
    if dmesh is not None:
        torch.distributed.barrier()


def run(args, model=None) -> dict:
    """Train ``args.steps`` steps (from LATEST with ``--resume``); returns
    the losses of the steps run, their host-clock seconds, the straggler
    count, the first step, the model, its optimizer state and the step
    function.  ``model`` (optional) is a built model on ``args.device``
    to train in place of ``--arch`` / ``--smoke`` (one device only).
    On a mesh of more than one device every rank runs this (module
    docstring)."""
    mesh = parse_mesh(args.mesh)
    rules = shd.rules_for_mesh(mesh) if mesh else None
    dmesh = None
    if mesh is not None and mesh.size > 1:
        if model is not None:
            raise ValueError("run(model=...) trains on one device")
        dev, dmesh = _sharded_device(mesh, args.device)
    else:
        dev = resolve_device(args.device)
    lead = dmesh is None or torch.distributed.get_rank() == 0
    if model is None:
        mod = C.get(args.arch)
        model = build_model(mod.SMOKE if args.smoke else mod.CONFIG,
                            device=dev, seed=args.seed)
        if dmesh is not None:
            shd.distribute_params(model, dmesh, rules)
    elif model.device.type != dev.type:
        raise ValueError(f"model is on {model.device}, --device is {dev}")
    cfg = model.cfg
    ocfg = opt.AdamWConfig(lr=args.lr, warmup_steps=20,
                           state_dtype=cfg.opt_state_dtype)
    gc_cfg = GradCompressConfig(enabled=args.grad_compress)
    step_fn = make_train_step(model, ocfg, args.microbatches, gc_cfg)
    tp_cfg = TokenPipelineConfig(
        vocab=cfg.vocab, batch=args.batch, seq_len=args.seq, seed=args.seed)
    state = init_train_state(model, ocfg, gc_cfg)

    start_step = 0
    if args.resume and args.ckpt_dir \
            and ckpt.latest_step(args.ckpt_dir) is not None:
        restored, manifest = ckpt.restore(
            args.ckpt_dir, checkpoint_trees(cfg, model, state))
        load_trees(cfg, model, state, restored)
        start_step = manifest["step"]
        if lead:
            print(f"[train] resumed from step {start_step}", flush=True)

    times, losses = [], []
    stragglers = 0
    with shd.use_rules(rules):
        for step in range(start_step, args.steps):
            t0 = time.perf_counter()
            batch = make_batch(cfg, tp_cfg, step, args.batch, args.seq, dev)
            if dmesh is not None:
                batch = place_batch(batch, dmesh, rules)
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            losses.append(loss)
            if len(times) >= 5:
                deadline = args.deadline_factor * statistics.median(times)
                if dt > deadline:
                    stragglers += 1
                    if lead:
                        print(f"[train] straggler: step {step} took "
                              f"{dt:.3f}s (deadline {deadline:.3f}s) -- "
                              "preemption hook would fire here", flush=True)
            times.append(dt)
            if lead and step % args.log_every == 0:
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"({dt * 1e3:.0f} ms)", flush=True)
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                save_checkpoint(args.ckpt_dir, step + 1, cfg, model,
                                state, loss, lead, dmesh)
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, args.steps, cfg, model, state,
                        losses[-1], lead, dmesh)
    return {"losses": losses, "seconds": times, "stragglers": stragglers,
            "start_step": start_step, "model": model, "state": state,
            "step_fn": step_fn, "tp_cfg": tp_cfg}


def main(argv=None):
    import torch.distributed as dist

    started = dist.is_initialized()
    out = run(parse_args(argv))
    losses = out["losses"]
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
              f"{out['stragglers']} straggler events", flush=True)
    if dist.is_initialized() and not started:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
