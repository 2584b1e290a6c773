"""Composable train step: micro-batched gradient accumulation + AdamW +
optional error-bounded gradient compression (the port of
``repro.train.train_step``).

``make_train_step(model, opt_cfg, microbatches, gc_cfg)`` returns

    train_step(state, batch) -> (state, metrics)

The parameters live in ``model`` and are updated in place; ``state`` has
the JAX package's layout, ``{"adam": {"m", "v", "step"},
"gc_residuals"?}``, keyed by the port's parameter names
(``convert.params_to_jax`` gives the reference's nested tree).
Micro-batching splits the leading batch axis (the (3, B, S)
``position_ids`` on axis 1) and sums the f32 gradients of the slices, so
peak activation memory is that of one micro-batch.  Nothing in a step
waits for the device: ``metrics["loss"]`` is a 0-d tensor.

Sharded: with the model's parameters DTensors on a device mesh
(``parallel.sharding.distribute_params``), the batch placed ``P(dp)``
and the mesh's rules active (``shd.use_rules``), the same step runs over
the mesh.  The loss and metrics come back as plain 0-d tensors, the
same on every rank; plain tensors the model makes (masks, positions)
count as replicated.  The micro-batches are the one-device step's, but
never fewer than one example per data shard (``_microbatches``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from ..parallel import sharding as shd
from . import grad_compress as gc
from . import optimizer as opt


def _split_batch(batch: Dict[str, torch.Tensor], n: int):
    """The ``n`` micro-batches of ``batch``: every leaf (B, ...) split on
    its leading axis, a (3, B, ...) leaf (position_ids) on axis 1.  A
    batch of DTensors is gathered over its data axes first (token
    batches are small) and each micro-batch placed on them again, so the
    micro-batches are the one-device step's."""
    if shd.is_sharded(*batch.values()):
        return _split_sharded(batch, n)

    def sp(x):
        if x.ndim >= 2 and x.shape[0] == 3 and x.shape[1] % n == 0:
            return x.reshape(3, n, x.shape[1] // n, *x.shape[2:]) \
                .transpose(0, 1)
        if x.shape[0] % n:
            raise ValueError(f"batch axis {x.shape[0]} does not split into "
                             f"{n} micro-batches")
        return x.reshape(n, x.shape[0] // n, *x.shape[1:])

    parts = {k: sp(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _split_sharded(batch, n: int):
    from torch.distributed.tensor import Replicate

    out = [dict() for _ in range(n)]
    for k, x in batch.items():
        mesh = x.device_mesh
        full = x.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
        for i, part in enumerate(_split_batch({k: full}, n)):
            out[i][k] = shd.place(part[k], shd.spec_of(x), mesh)
    return out


def _microbatches(batch, n: int) -> int:
    """``n``, or for a batch placed over data-parallel ranks at most one
    micro-batch per example of a data shard (the dry run's rule: never
    below one example per shard)."""
    labels = batch["labels"]
    if n == 1 or not shd.is_sharded(labels):
        return n
    dp = 1
    for p, size in zip(labels.placements, labels.device_mesh.shape):
        if p.is_shard(0):
            dp *= size
    return max(min(n, labels.shape[0] // dp), 1)


def _sharded_context(params: dict):
    """``implicit_replication`` for a model with DTensor parameters (the
    plain tensors a step makes count as replicated), else nothing."""
    if shd.is_sharded(*params.values()):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        return implicit_replication()
    return contextlib.nullcontext()


def _replicated(x):
    """A DTensor scalar reduced to its value on every rank (plain)."""
    if shd.is_sharded(x):
        from torch.distributed.tensor import Replicate

        mesh = x.device_mesh
        return x.redistribute(mesh, [Replicate()] * mesh.ndim)
    return x


def _plain(x):
    return x.to_local() if shd.is_sharded(x) else x


def value_and_grad(model, params: dict, batch):
    """(loss, metrics, grads): ``model.train_loss(batch)`` and its gradient
    with respect to ``params`` (name -> parameter requiring grad), each
    leaf in its parameter's dtype (zeros for a parameter the loss does
    not use, e.g. the embedding table under embedding inputs)."""
    with _sharded_context(params):
        loss, metrics = model.train_loss(batch)
        loss = _replicated(loss)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True, materialize_grads=True)
    return (_plain(loss.detach()),
            {k: _plain(_replicated(v.detach())) for k, v in metrics.items()},
            dict(zip(params, grads)))


def make_train_step(model, opt_cfg: opt.AdamWConfig, microbatches: int = 1,
                    gc_cfg: Optional[gc.GradCompressConfig] = None):
    gc_cfg = gc_cfg or gc.GradCompressConfig()
    model.requires_grad_(True)
    params = dict(model.named_parameters())

    def grads_of(batch):
        n_mb = _microbatches(batch, microbatches)
        if n_mb == 1:
            return value_and_grad(model, params, batch)
        gsum = lsum = None
        for mb in _split_batch(batch, n_mb):
            loss, _, g = value_and_grad(model, params, mb)
            if gsum is None:
                gsum = {n: t.float() for n, t in g.items()}
                lsum = loss.float()
            else:
                for n, t in g.items():
                    gsum[n].add_(t)
                lsum = lsum + loss
        div = torch.full((), n_mb, dtype=torch.float32, device=lsum.device)
        return lsum / div, {}, {n: t / div for n, t in gsum.items()}

    def train_step(state, batch):
        loss, metrics, grads = grads_of(batch)
        residuals = state.get("gc_residuals")
        gcm = {}
        if gc_cfg.enabled:
            grads, residuals, gcm = gc.compress_grads(grads, residuals,
                                                      gc_cfg)
        _, adam, om = opt.apply_updates(params, grads, state["adam"],
                                        opt_cfg)
        new_state = {"adam": adam}
        if gc_cfg.enabled:
            new_state["gc_residuals"] = residuals
        metrics = dict(metrics)
        metrics.update(om)
        metrics.update(gcm)
        metrics["loss"] = loss
        return new_state, metrics

    return train_step


def init_train_state(model, opt_cfg: opt.AdamWConfig,
                     gc_cfg: Optional[gc.GradCompressConfig] = None):
    """The optimizer state of ``model``'s parameters (the parameters
    themselves are the model's, from ``build_model``'s seed)."""
    params = dict(model.named_parameters())
    state = {"adam": opt.init_state(params, opt_cfg)}
    if gc_cfg and gc_cfg.enabled:
        state["gc_residuals"] = gc.init_residuals(params)
    return state
