"""Mamba (S6) selective-state-space mixer for the hybrid (Jamba) family.

The port of ``repro.models.mamba``.  Prefill runs the recurrence
h_t = abar_t h_{t-1} + bx_t chunk by chunk of ``scan_chunk`` tokens,
step by step inside a chunk: the JAX package's intra-chunk
``associative_scan`` computes the same recurrence in another association
order, so the two agree to f32 rounding (tests state the tolerance).
Each chunk's body is recomputed in the backward pass and casts its output
to the activation dtype, as the JAX package's scan body does (perf
iterations H2, H3; ``REPRO_PERF_BASELINE=1`` turns both off).
Decode is the O(1) recurrent update carrying (conv_state, ssm_state).
On a mesh the recurrence runs on each device's batch and channel shards.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import perfflags
from ..parallel import sharding as shd
from .config import ModelConfig
from .layers import Init, Params, dense_init, pdtype_of


def d_inner(cfg: ModelConfig) -> int:
    return cfg.mamba_expand * cfg.d_model


def dt_rank(cfg: ModelConfig) -> int:
    return max(cfg.d_model // 16, 1)


def mamba_params(cfg: ModelConfig, init: Init):
    d = cfg.d_model
    di = d_inner(cfg)
    ds = cfg.mamba_d_state
    dr = dt_rank(cfg)
    dc = cfg.mamba_d_conv
    pd = pdtype_of(cfg)
    a = torch.arange(1, ds + 1, dtype=torch.float32,
                     device=init.device)[None, :].repeat(di, 1)
    return {
        "in_proj": dense_init(init, d, 2 * di, pd),
        "conv_w": (init.normal((dc, di)) * 0.1).to(pd),
        "conv_b": init.full((di,), 0.0, pd),
        "x_proj": dense_init(init, di, dr + 2 * ds, pd),
        "dt_proj": dense_init(init, dr, di, pd),
        "dt_bias": init.full((di,), 0.0, pd),
        "a_log": torch.log(a).to(pd),          # A = -exp(a_log)
        "d_skip": init.full((di,), 1.0, pd),
        "out_proj": dense_init(init, di, d, pd),
    }


def _ssm_inputs(cfg, p: Params, xc):
    """xc (B, L, di) post-conv activations -> discretized (abar, bx, c)."""
    ds = cfg.mamba_d_state
    dr = dt_rank(cfg)
    dt_ = xc.dtype
    dt_bc = xc @ p.cast("x_proj", dt_)                     # (B, L, dr+2ds)
    dt = dt_bc[..., :dr] @ p.cast("dt_proj", dt_) + p.cast("dt_bias", dt_)
    dt = F.softplus(dt.float())                            # (B, L, di)
    b = dt_bc[..., dr:dr + ds].float()                     # (B, L, ds)
    c = dt_bc[..., dr + ds:].float()                       # (B, L, ds)
    a = -torch.exp(p["a_log"].float())                     # (di, ds)
    abar = torch.exp(dt[..., None] * a[None, None])        # (B, L, di, ds)
    bx = (dt * xc.float())[..., None] * b[..., None, :]
    return abar, bx, c


def _chunk_scan(abar, bx, h0):
    """h_t = abar_t h_{t-1} + bx_t over a chunk, from h0 (B, di, ds).
    Returns (h (B, L, di, ds), h at the chunk's end)."""
    hs = []
    h = h0
    for t in range(abar.shape[1]):
        h = abar[:, t] * h + bx[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def _scan_out(abar, bx, c, h0):
    """(y (B, L, di), h at the chunk's end) of a chunk from h0."""
    h_seq, h_last = _chunk_scan(abar, bx, h0)
    return torch.einsum("blds,bls->bld", h_seq, c), h_last


def _scan_specs(abar, c, h0):
    """Batch over dp, channels (di) over tp: the recurrence never crosses
    a shard."""
    r = shd.current_rules()
    if r is None or not shd.is_sharded(abar):
        return [None] * 4, [None] * 2
    chan = shd.fit_spec(shd.P(r.dp, None, r.tp, None), abar.shape,
                        shd.mesh_sizes(abar.device_mesh))
    dp, tp = chan[0], chan[2]
    return ([chan, chan, shd.P(dp, None, None), shd.P(dp, tp, None)],
            [shd.P(dp, None, tp), shd.P(dp, tp, None)])


def causal_conv(cfg, p: Params, x, conv_state=None):
    """Depthwise causal conv along time.  x (B, L, di)."""
    dc = cfg.mamba_d_conv
    w = p.cast("conv_w", x.dtype)                          # (dc, di)
    if conv_state is None:
        pad = torch.zeros((x.shape[0], dc - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                        # (B, L+dc-1, di)
    L = x.shape[1]
    out = xp[:, 0:L] * w[0][None, None]
    for i in range(1, dc):
        out = out + xp[:, i:i + L] * w[i][None, None]
    new_state = xp[:, -(dc - 1):] if dc > 1 else pad[:, :0]
    return out + p.cast("conv_b", x.dtype), new_state


def mamba_forward(cfg: ModelConfig, p: Params, x, chunk=None,
                  return_state=False):
    """Prefill forward.  x (B, S, D) -> (B, S, D) [, final state]."""
    B, S, D = x.shape
    di = d_inner(cfg)
    ds = cfg.mamba_d_state
    chunk = chunk or cfg.scan_chunk
    dt = x.dtype

    xz = x @ p.cast("in_proj", dt)                         # (B, S, 2di)
    xin, z = xz[..., :di], xz[..., di:]
    xc, _ = causal_conv(cfg, p, xin)
    xc = F.silu(xc)

    if S % chunk != 0:
        chunk = S  # degenerate sizes: single chunk

    def body(h, xck):
        abar, bx, c = _ssm_inputs(cfg, p, xck)
        ins, outs = _scan_specs(abar, c, h)
        y, h_last = shd.on_shards(_scan_out, (abar, bx, c, h), ins, outs)
        return h_last, (y if perfflags.BASELINE else y.to(dt))  # (B, L, di)

    body = perfflags.checkpoint_if_optimized(body)
    h = torch.zeros((B, di, ds), dtype=torch.float32, device=x.device)
    ys = []
    for start in range(0, S, chunk):
        h, y = body(h, xc[:, start:start + chunk])
        ys.append(y)
    y = torch.cat(ys, dim=1)
    y = (y + xc * p.cast("d_skip", dt)).to(dt)
    y = y * F.silu(z)
    out = y @ p.cast("out_proj", dt)
    if return_state:
        dc = cfg.mamba_d_conv
        conv_state = xin[:, -(dc - 1):] if dc > 1 else xin[:, :0]
        return out, {"conv": conv_state, "ssm": h}
    return out


def mamba_init_state(cfg: ModelConfig, batch, dtype=torch.float32, *,
                     device):
    di = d_inner(cfg)
    return {
        "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, di, cfg.mamba_d_state),
                           dtype=torch.float32, device=device),
    }


def mamba_decode_step(cfg: ModelConfig, p: Params, x, state):
    """x (B, 1, D); state dict -> (out (B, 1, D), new state)."""
    di = d_inner(cfg)
    dt = x.dtype
    xz = x @ p.cast("in_proj", dt)
    xin, z = xz[..., :di], xz[..., di:]
    xc, conv_state = causal_conv(cfg, p, xin, state["conv"])
    xc = F.silu(xc)
    abar, bx, c = _ssm_inputs(cfg, p, xc)                  # L = 1
    h = state["ssm"] * abar[:, 0] + bx[:, 0]               # (B, di, ds)
    y = torch.einsum("bds,bs->bd", h, c[:, 0])[:, None]    # (B, 1, di)
    y = y + xc.float() * p["d_skip"].float()
    y = y.to(dt) * F.silu(z)
    out = y @ p.cast("out_proj", dt)
    return out, {"conv": conv_state.to(state["conv"].dtype), "ssm": h}
