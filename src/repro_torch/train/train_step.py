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
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import grad_compress as gc
from . import optimizer as opt


def _split_batch(batch: Dict[str, torch.Tensor], n: int):
    """The ``n`` micro-batches of ``batch``: every leaf (B, ...) split on
    its leading axis, a (3, B, ...) leaf (position_ids) on axis 1."""

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


def value_and_grad(model, params: dict, batch):
    """(loss, metrics, grads): ``model.train_loss(batch)`` and its gradient
    with respect to ``params`` (name -> parameter requiring grad), each
    leaf in its parameter's dtype (zeros for a parameter the loss does
    not use, e.g. the embedding table under embedding inputs)."""
    loss, metrics = model.train_loss(batch)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(params, grads)))


def make_train_step(model, opt_cfg: opt.AdamWConfig, microbatches: int = 1,
                    gc_cfg: Optional[gc.GradCompressConfig] = None):
    gc_cfg = gc_cfg or gc.GradCompressConfig()
    model.requires_grad_(True)
    params = dict(model.named_parameters())

    def grads_of(batch):
        if microbatches == 1:
            return value_and_grad(model, params, batch)
        gsum = lsum = None
        for mb in _split_batch(batch, microbatches):
            loss, _, g = value_and_grad(model, params, mb)
            if gsum is None:
                gsum = {n: t.float() for n, t in g.items()}
                lsum = loss.float()
            else:
                for n, t in g.items():
                    gsum[n].add_(t)
                lsum = lsum + loss
        div = torch.full((), microbatches, dtype=torch.float32,
                         device=lsum.device)
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
