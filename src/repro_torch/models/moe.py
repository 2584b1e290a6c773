"""Mixture-of-Experts layer (GShard-style capacity dispatch).

The port of ``repro.models.moe``: top-k routing in independent groups of
``GROUP_SIZE`` tokens (one group at ragged sizes), renormalized gates,
each (token, k) placed in its expert's queue by a cumulative sum, the
ones past the capacity dropped, one-hot dispatch / combine einsums,
shared experts and the load-balancing auxiliary loss.

On a mesh (DTensor parameters) the routed experts run on each device's
shards: expert parallelism over the model axis (each rank its E / tp
experts' weights, gathered over the data axis, and a partial sum of the
output over the model axis), the routing groups over the data axes when
whole groups fall on each data shard.  Where they do not (one group
spans the batch, as at the SMOKE sizes) the layer's input is first
replicated over the data axes and every data rank routes all groups, as
the one-device layer does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import perfflags
from ..parallel import sharding as shd
from .config import ModelConfig
from .layers import Init, Params, dense_init, pdtype_of


def moe_params(cfg: ModelConfig, init: Init):
    d = cfg.d_model
    ff = cfg.d_ff_expert or cfg.d_ff
    e = cfg.n_experts
    pd = pdtype_of(cfg)
    p = {
        "router": dense_init(init, d, e, pd, scale=0.02),
        "w_gate": (init.normal((e, d, ff)) / math.sqrt(d)).to(pd),
        "w_up": (init.normal((e, d, ff)) / math.sqrt(d)).to(pd),
        "w_down": (init.normal((e, ff, d)) / math.sqrt(ff)).to(pd),
    }
    if cfg.n_shared_experts:
        ffs = ff * cfg.n_shared_experts
        p["shared"] = {
            "w_gate": dense_init(init, d, ffs, pd),
            "w_up": dense_init(init, d, ffs, pd),
            "w_down": dense_init(init, ffs, d, pd),
        }
    return p


def _one_hot(idx, n: int, dtype):
    """``F.one_hot(idx, n).to(dtype)`` as one comparison: the same values,
    without one_hot's range checks (a device sync on the CPU) and with
    the same ops on real and fake tensors (the dry run traces the
    latter)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


GROUP_SIZE = 1024  # routing-group size: dispatch memory is O(G * Sg * E * Cg)


def _groups(cfg: ModelConfig, n_tokens: int):
    """(group size, groups, capacity) for ``n_tokens`` routed tokens."""
    sg = min(GROUP_SIZE, n_tokens)
    if n_tokens % sg != 0:
        sg = n_tokens  # degenerate smoke-test sizes: one group
    cap = max(int(cfg.capacity_factor * cfg.top_k * sg / cfg.n_experts),
              cfg.top_k)
    return sg, n_tokens // sg, cap


def route(cfg: ModelConfig, p: Params, x):
    """Routing of x (B, S, D): a dict of the router probabilities
    (G, Sg, E) f32, the top-k gates (renormalized) and experts
    (G, Sg, K), each (token, k)'s queue position and whether it is kept
    (position < capacity), and the one-hot ``dispatch`` (G, Sg, E, cap)
    and gate-weighted ``combine`` tensors in the activation dtype."""
    return _route(cfg, _router(p, x.dtype), x)


def _router(p: Params, dt):
    """The router weight the logits take: the activation-dtype cast in f32
    (H5; BASELINE: the f32 router)."""
    if perfflags.BASELINE:
        return p["router"].float()
    return p.cast("router", dt).float()


def _route(cfg: ModelConfig, router, x):
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    sg, G, cap = _groups(cfg, B * S)
    dt = x.dtype
    xf = x.reshape(G, sg, D)
    # router logits: an f32 sum of the activation-dtype products (H5;
    # BASELINE: of the f32 activations and router)
    logits = xf.float() @ router
    probs = torch.softmax(logits, dim=-1)                      # (G, Sg, E)
    # lax.top_k: descending, ties to the lower index (a stable sort)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = order.values[..., :K], order.indices[..., :K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    # position of each (token, k) within its expert queue (per group)
    flat = _one_hot(expert_idx, E, torch.int32).reshape(G, sg * K, E)
    pos_in_expert = torch.cumsum(flat, dim=1, dtype=torch.int32) - flat
    pos = (pos_in_expert * flat).sum(-1).reshape(G, sg, K)
    keep = pos < cap
    disp = (_one_hot(expert_idx, E, dt)[..., None]
            * _one_hot(torch.where(keep, pos, cap), cap + 1,
                       dt)[:, :, :, None, :-1])               # (G,Sg,K,E,cap)
    return {
        "probs": probs, "gate_vals": gate_vals, "expert_idx": expert_idx,
        "pos": pos, "keep": keep, "cap": cap,
        "dispatch": disp.sum(2),
        "combine": (disp * gate_vals.to(dt)[..., None, None]).sum(2),
    }


def apply_moe(cfg: ModelConfig, p: Params, x):
    """x (B, S, D) -> (out (B, S, D), aux_loss scalar f32)."""
    if shd.is_sharded(x):
        return _apply_moe_sharded(cfg, p, x)
    B, S, D = x.shape
    E = cfg.n_experts
    N = B * S
    dt = x.dtype
    r = route(cfg, p, x)
    xf = x.reshape(r["dispatch"].shape[0], -1, D)
    expert_in = torch.einsum("gsd,gsec->egcd", xf, r["dispatch"])
    gate = F.silu(torch.einsum("egcd,edf->egcf", expert_in,
                               p.cast("w_gate", dt)))
    up = torch.einsum("egcd,edf->egcf", expert_in, p.cast("w_up", dt))
    expert_out = torch.einsum("egcf,efd->egcd", gate * up,
                              p.cast("w_down", dt))
    out = torch.einsum("egcd,gsec->gsd", expert_out, r["combine"])

    xflat = xf.reshape(N, D)
    out = out.reshape(N, D)
    if cfg.n_shared_experts:
        sp = p["shared"]
        g = F.silu(xflat @ sp.cast("w_gate", dt))
        out = out + (g * (xflat @ sp.cast("w_up", dt))) @ sp.cast("w_down", dt)

    # load-balancing auxiliary loss (Switch/GShard form)
    density = _one_hot(r["expert_idx"][..., 0], E, torch.float32).mean((0, 1))
    density_proxy = r["probs"].mean((0, 1))
    aux = (density * density_proxy).sum() * E
    return out.reshape(B, S, D), aux.float()


def _experts(cfg: ModelConfig, router, w_gate, w_up, w_down, x, e0: int,
             count: float):
    """The routed experts ``e0 .. e0 + len(w_gate)`` of one device's
    tokens ``x`` (B, S, D): (their share of the output (B, S, D), and
    ``count`` times the summed top-1 one-hot (E,) and router
    probabilities (E,) over the tokens, for the auxiliary loss)."""
    B, S, D = x.shape
    E = cfg.n_experts
    dt = x.dtype
    r = _route(cfg, router, x)
    e1 = e0 + w_gate.shape[0]
    xf = x.reshape(r["dispatch"].shape[0], -1, D)
    expert_in = torch.einsum("gsd,gsec->egcd", xf, r["dispatch"][:, :, e0:e1])
    gate = F.silu(torch.einsum("egcd,edf->egcf", expert_in, w_gate.to(dt)))
    up = torch.einsum("egcd,edf->egcf", expert_in, w_up.to(dt))
    expert_out = torch.einsum("egcf,efd->egcd", gate * up, w_down.to(dt))
    out = torch.einsum("egcd,gsec->gsd", expert_out,
                       r["combine"][:, :, e0:e1])
    top1 = _one_hot(r["expert_idx"][..., 0], E, torch.float32).sum((0, 1))
    return out.reshape(B, S, D), top1 * count, r["probs"].sum((0, 1)) * count


def _apply_moe_sharded(cfg: ModelConfig, p: Params, x):
    """``apply_moe`` of a DTensor ``x`` on its mesh (module docstring)."""
    B, S, D = x.shape
    E = cfg.n_experts
    N = B * S
    dt = x.dtype
    r = shd.current_rules()
    sizes = shd.mesh_sizes(x.device_mesh)
    dp = 1
    for a in r.dp:
        dp *= sizes[a]
    sg, G, _ = _groups(cfg, N)
    # whole groups on each data shard: route them there; else every data
    # rank routes the whole batch (the input replicated over dp)
    batch = r.dp if G % dp == 0 and B % dp == 0 and (B // dp) * S % sg == 0 \
        else None
    tp = r.tp if r.tp and E % sizes[r.tp] == 0 else None
    e_local = E // (sizes[tp] if tp else 1)
    e0 = x.device_mesh.get_local_rank(tp) * e_local if tp else 0
    w = shd.P(tp, None, None)
    # the output is a partial sum over the expert shards; the routing
    # statistics over the data shards, and over the expert shards with
    # all but the first counting 0 (every expert shard routes the same
    # tokens, so each statistic and its gradient are taken once)
    stats = tuple(batch or ()) + ((tp,) if tp else ())
    sums = {0: (tp,) if tp else (), 1: stats, 2: stats}
    count = 1.0 if e0 == 0 else 0.0
    out, top1, psum = shd.on_shards(
        lambda rw, wg, wu, wd, xx: _experts(cfg, rw, wg, wu, wd, xx, e0,
                                            count),
        (_router(p, dt), p.cast("w_gate", dt), p.cast("w_up", dt),
         p.cast("w_down", dt), x),
        [shd.P(), w, w, w, shd.P(batch, None, None)],
        [shd.P(batch, None, None), shd.P(), shd.P()], partial=sums)
    if cfg.n_shared_experts:
        sp = p["shared"]
        g = F.silu(x @ sp.cast("w_gate", dt))
        out = out + (g * (x @ sp.cast("w_up", dt))) @ sp.cast("w_down", dt)
    # load-balancing auxiliary loss (Switch/GShard form) over all tokens
    aux = ((top1 / N) * (psum / N)).sum() * E
    return out, aux.float()
