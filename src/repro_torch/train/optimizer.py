"""AdamW (the port of ``repro.train.optimizer``).

Hand-rolled, as in the JAX package.  The state holds ``m`` and ``v``
keyed by the port's parameter names, in ``state_dtype`` ('float32' or
'bfloat16', the latter for the 398B hybrid), and ``step``, a 0-d int32
tensor on the device.  Every scalar of the update (bias corrections,
warm-up learning rate, clip scale) is an f32 tensor on the device, as in
the JAX package, so a step never waits for the device.

``apply_updates`` writes the new parameters, m and v into their tensors
(the JAX package's train step donates them to the same end).

On a mesh (DTensor parameters) m and v are DTensors placed as their
parameters, each gradient is placed so too before the norm (a gradient
that arrives ``Partial``, as a replicated input's does, is summed over
its ranks there), and the update runs on the local shards; the global
norm is one reduction over the mesh.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.config import torch_dtype
from ..models.convert import is_stacked
from ..parallel import sharding as shd


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    state_dtype: str = "float32"


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """The f32 scalar ``x`` on ``like``'s device (a divisor: CUDA divides
    by a host scalar as a product with its reciprocal)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def init_state(params: dict, cfg: AdamWConfig) -> dict:
    dt = torch_dtype(cfg.state_dtype)
    dev = next(iter(params.values())).device

    def zeros():
        return {n: torch.zeros_like(p, dtype=dt) if shd.is_sharded(p)
                else torch.zeros(p.shape, dtype=dt, device=p.device)
                for n, p in params.items()}

    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step.float() / _f32(max(cfg.warmup_steps, 1), step),
                       max=1.0)
    return cfg.lr * warm


def global_norm(tree: dict) -> torch.Tensor:
    if shd.is_sharded(*tree.values()):
        return _sharded_norm(tree)
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tree.values()))


def _sharded_norm(tree: dict) -> torch.Tensor:
    """The global norm of DTensor leaves as one reduction over the mesh:
    each rank sums the squares of its shards, a leaf replicated over
    axes of n ranks in all weighted 1 / n (a power of two on every mesh
    here: exact), then one sum over the ranks.  A ``Partial`` leaf is
    summed over its ranks first (the square of a sum is not the sum of
    the squares).  A plain 0-d tensor."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    local = None
    mesh = None
    for t in tree.values():
        mesh = t.device_mesh
        if any(p.is_partial() for p in t.placements):
            t = t.redistribute(mesh, [Replicate() if p.is_partial() else p
                                      for p in t.placements])
        reps = 1
        for p, m in zip(t.placements, mesh.shape):
            if not p.is_shard():
                reps *= m
        sq = (t.to_local().float() ** 2).sum() / reps
        local = sq if local is None else local + sq
    n = mesh.ndim
    total = DTensor.from_local(local, mesh, [Partial()] * n, run_check=False)
    return torch.sqrt(total.redistribute(mesh, [Replicate()] * n).to_local())


def decays(name: str, p: torch.Tensor) -> bool:
    """The JAX package decays a leaf of two or more dimensions; its block
    leaves carry the stacked layer axis, which the port's do not."""
    return p.ndim + is_stacked(name) >= 2


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: dict, cfg: AdamWConfig):
    """One AdamW step over ``params`` (name -> tensor), in place.  Returns
    (params, new state, metrics)."""
    step = state["step"] + 1
    if shd.is_sharded(*params.values()):   # each as its parameter
        grads = {n: g.redistribute(params[n].device_mesh,
                                   params[n].placements)
                 for n, g in grads.items()}
    gnorm = global_norm(grads)
    scale = torch.clamp(_f32(cfg.grad_clip, gnorm)
                        / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = _schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()
    for name, p in params.items():
        m, v = state["m"][name], state["v"][name]
        g = grads[name]
        if shd.is_sharded(p):      # the update on this rank's shards
            g, p, m, v = g.to_local(), p.to_local(), m.to_local(), \
                v.to_local()
        g = g.float() * scale
        m32 = m.float() * b1 + g * (1 - b1)
        v32 = v.float() * b2 + g * g * (1 - b2)
        delta = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
        if decays(name, p):   # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    return (params, {"m": state["m"], "v": state["v"], "step": step},
            {"grad_norm": gnorm, "lr": lr})
