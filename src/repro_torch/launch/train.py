"""End-to-end training launcher with checkpoint/restart and straggler
mitigation, on one device (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm_1_6b \
        --smoke --steps 200 --ckpt-dir /tmp/ckpt [--resume] \
        [--grad-compress] [--device cpu]

Same flags and defaults as the JAX launcher, plus ``--device`` (the CUDA
device unless ``--device cpu`` is given).  ``--mesh 1x1`` trains under the
sharding rules of the one device's mesh, as without it; a mesh of more
than one device is refused (sharded training: ROADMAP Queue 1 item 13d).

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
                    help="e.g. 1x1 (one device; larger meshes are refused)")
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


def checkpoint_trees(cfg, model, state) -> dict:
    """{"params", "opt"} in the reference's layout, on the host."""

    def tree(named):
        return params_to_jax(cfg, {n: t.detach().cpu()
                                   for n, t in named.items()})

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
            t.copy_(sd[n])

    into(dict(model.named_parameters()), trees["params"])
    adam, src = state["adam"], trees["opt"]["adam"]
    into(adam["m"], src["m"])
    into(adam["v"], src["v"])
    adam["step"].copy_(torch.from_numpy(np.asarray(src["step"])))
    if "gc_residuals" in state:
        into(state["gc_residuals"], trees["opt"]["gc_residuals"])


def run(args, model=None) -> dict:
    """Train ``args.steps`` steps (from LATEST with ``--resume``); returns
    the losses of the steps run, their host-clock seconds, the straggler
    count, the first step, the model, its optimizer state and the step
    function.  ``model`` (optional) is a built model on ``args.device``
    to train in place of ``--arch`` / ``--smoke``."""
    mesh = parse_mesh(args.mesh)
    if mesh is not None and mesh.size > 1:
        raise NotImplementedError(
            f"--mesh {args.mesh}: training over {mesh.size} devices is not "
            "ported to repro_torch (ROADMAP Queue 1 item 13d, sharded "
            "execution); --mesh 1x1 trains on one device")
    rules = shd.rules_for_mesh(mesh) if mesh else None
    dev = resolve_device(args.device)
    if model is None:
        mod = C.get(args.arch)
        model = build_model(mod.SMOKE if args.smoke else mod.CONFIG,
                            device=dev, seed=args.seed)
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
        print(f"[train] resumed from step {start_step}", flush=True)

    times, losses = [], []
    stragglers = 0
    with shd.use_rules(rules):
        for step in range(start_step, args.steps):
            t0 = time.perf_counter()
            batch = make_batch(cfg, tp_cfg, step, args.batch, args.seq, dev)
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            losses.append(loss)
            if len(times) >= 5:
                deadline = args.deadline_factor * statistics.median(times)
                if dt > deadline:
                    stragglers += 1
                    print(f"[train] straggler: step {step} took {dt:.3f}s "
                          f"(deadline {deadline:.3f}s) -- preemption hook "
                          f"would fire here", flush=True)
            times.append(dt)
            if step % args.log_every == 0:
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"({dt * 1e3:.0f} ms)", flush=True)
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                ckpt.save(args.ckpt_dir, step + 1,
                          checkpoint_trees(cfg, model, state),
                          meta={"arch": cfg.name, "loss": loss})
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps,
                  checkpoint_trees(cfg, model, state),
                  meta={"arch": cfg.name, "loss": losses[-1]})
    return {"losses": losses, "seconds": times, "stragglers": stragglers,
            "start_step": start_step, "model": model, "state": state,
            "step_fn": step_fn, "tp_cfg": tp_cfg}


def main(argv=None):
    out = run(parse_args(argv))
    losses = out["losses"]
    print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"{out['stragglers']} straggler events", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
