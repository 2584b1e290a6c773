"""RWKV6 ("Finch") attention-free mixer with data-dependent decay.

The port of ``repro.models.rwkv``.  Time-mix recurrence per head (state
S in R^{dk x dv}):

    out_t = r_t @ (S_{t-1} + diag(u) k_t v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T

with the data-dependent per-channel decay w_t = exp(-exp(w0 + LoRA(x))),
static token-shift mixing and per-head RMS normalization of the output.

Prefill is chunk-parallel: within a chunk every decay exponent is a
difference cum_{t-1} - cum_s clamped at <= 0, so every exp() is <= 1;
across chunks a loop carries S, each chunk's body recomputed in the
backward pass (perf iteration H2; ``REPRO_PERF_BASELINE=1`` turns it
off).  Decode is the O(1) recurrence.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import perfflags
from ..parallel import sharding as shd
from .config import ModelConfig
from .layers import Init, Params, dense_init, pdtype_of

LORA_RANK = 64


def n_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.rwkv_head_dim


def rwkv_params(cfg: ModelConfig, init: Init):
    d = cfg.d_model
    pd = pdtype_of(cfg)
    half = lambda: init.full((d,), 0.5, pd)  # noqa: E731
    return {
        "mix_r": half(), "mix_k": half(), "mix_v": half(), "mix_g": half(),
        "mix_w": half(),
        "wr": dense_init(init, d, d, pd),
        "wk": dense_init(init, d, d, pd),
        "wv": dense_init(init, d, d, pd),
        "wg": dense_init(init, d, d, pd),
        "wo": dense_init(init, d, d, pd),
        "w0": init.full((d,), -1.0, pd),             # base log-log decay
        "w_lora_a": dense_init(init, d, LORA_RANK, pd),
        "w_lora_b": dense_init(init, LORA_RANK, d, pd, scale=0.01),
        "u": (init.normal((d,)) * 0.1).to(pd),
        "ln_scale": init.full((d,), 1.0, pd),
        # channel mix
        "cmix_k": half(), "cmix_r": half(),
        "c_wk": dense_init(init, d, cfg.d_ff, pd),
        "c_wv": dense_init(init, cfg.d_ff, d, pd),
        "c_wr": dense_init(init, d, d, pd),
    }


def _shift(x, last=None):
    """Token shift: x_{t-1} (zeros / `last` for t = 0).  x (B, S, D)."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1)


def _mix(p: Params, name, x, xs):
    return x + (xs - x) * p.cast(name, x.dtype)


def _decay(cfg, p: Params, xw):
    """Data-dependent per-channel decay, log-space.  Returns log(w) <= 0."""
    lora = torch.tanh(xw.float() @ p["w_lora_a"].float())
    lora = lora @ p["w_lora_b"].float()
    return -torch.exp(p["w0"].float() + lora)


def _headnorm(x, scale):
    """Per-head RMS normalization of (B, S, H, hd)."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + 1e-6)
    B, S, H, hd = x.shape
    return (out.reshape(B, S, H * hd) * scale.float()).to(x.dtype)


def _projections(cfg, p: Params, x, xs):
    """r, k, v (B, S, D) and the gate g, and log w (B, S, D) f32."""
    dt = x.dtype
    # D over the model axis before the head split
    r = shd.act(_mix(p, "mix_r", x, xs) @ p.cast("wr", dt), "logits")
    k = shd.act(_mix(p, "mix_k", x, xs) @ p.cast("wk", dt), "logits")
    v = shd.act(_mix(p, "mix_v", x, xs) @ p.cast("wv", dt), "logits")
    g = _mix(p, "mix_g", x, xs) @ p.cast("wg", dt)
    return r, k, v, g, _decay(cfg, p, _mix(p, "mix_w", x, xs))


def time_mix(cfg: ModelConfig, p: Params, x, chunk=None, state=None,
             last_x=None):
    """Chunk-parallel WKV.  x (B, S, D).  state (B, H, dk, dv) or None.

    Returns (out, final_state, final_x) so decode/prefill can chain.
    """
    B, S, D = x.shape
    H = n_heads(cfg)
    hd = cfg.rwkv_head_dim
    chunk = chunk or cfg.scan_chunk
    if S % chunk != 0:
        chunk = S
    dt = x.dtype

    r, k, v, g, logw = _projections(cfg, p, x, _shift(x, last_x))
    rf = r.float().reshape(B, S, H, hd)
    kf = k.float().reshape(B, S, H, hd)
    vf = v.float().reshape(B, S, H, hd)
    lw = logw.reshape(B, S, H, hd)
    u = p["u"].float().reshape(H, hd)

    if state is None:
        state = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                            device=x.device)
    tmask = torch.ones((chunk, chunk), dtype=torch.bool,
                       device=x.device).tril(-1)[None, :, :, None, None]

    def body(S_in, rc, kc, vc, lwc):
        cum = torch.cumsum(lwc, dim=1)               # (B, L, H, dk)
        cum_prev = cum - lwc                         # cum_{t-1}
        # cross-chunk: r_t decayed to chunk start @ S_in
        out_cross = torch.einsum("blhd,bhdv->blhv", rc * torch.exp(cum_prev),
                                 S_in)
        # intra-chunk pairwise with safe exponents (<= 0)
        ediff = cum_prev[:, :, None] - cum[:, None, :]      # (B, t, s, H, dk)
        e = torch.where(tmask, torch.exp(torch.clamp(ediff, max=0.0)),
                        torch.zeros((), device=x.device))
        a = torch.einsum("bthd,bshd,btshd->bths", rc, kc, e)
        out_intra = torch.einsum("bths,bshv->bthv", a, vc)
        # current-token bonus
        diag = torch.einsum("blhd,blhd->blh", rc, kc * u[None, None])
        out_diag = diag[..., None] * vc
        # state update (factors <= 1)
        k_dec = kc * torch.exp(cum[:, -1:] - cum)
        S_out = S_in * torch.exp(cum[:, -1])[..., None] + torch.einsum(
            "bshd,bshv->bhdv", k_dec, vc)
        return S_out, out_cross + out_intra + out_diag

    body = perfflags.checkpoint_if_optimized(body)
    outs = []
    S_run = state
    for start in range(0, S, chunk):
        sl = slice(start, start + chunk)
        S_run, out = body(S_run, rf[:, sl], kf[:, sl], vf[:, sl], lw[:, sl])
        outs.append(out)
    out = torch.cat(outs, dim=1).to(dt)
    out = _headnorm(out, p["ln_scale"])
    out = out * F.silu(g)
    return out @ p.cast("wo", dt), S_run, x[:, -1:]


def time_mix_decode(cfg: ModelConfig, p: Params, x, state, last_x):
    """Single-token recurrence.  x (B, 1, D)."""
    B, _, D = x.shape
    H = n_heads(cfg)
    hd = cfg.rwkv_head_dim
    dt = x.dtype
    r, k, v, g, logw = _projections(cfg, p, x, last_x)
    rf = r.float().reshape(B, H, hd)
    kf = k.float().reshape(B, H, hd)
    vf = v.float().reshape(B, H, hd)
    w = torch.exp(logw).reshape(B, H, hd)
    u = p["u"].float().reshape(H, hd)
    wkv = state + (kf * u[None])[..., None] * vf[:, :, None, :]
    out = torch.einsum("bhd,bhdv->bhv", rf, wkv)       # (B, H, dv)
    new_state = state * w[..., None] + kf[..., None] * vf[:, :, None, :]
    out = out.reshape(B, 1, D).to(dt)
    out = _headnorm(out.reshape(B, 1, H, hd), p["ln_scale"])
    out = out * F.silu(g)
    return out @ p.cast("wo", dt), new_state, x


def channel_mix(cfg: ModelConfig, p: Params, x, last_x=None):
    dt = x.dtype
    xs = _shift(x, last_x)
    xk = _mix(p, "cmix_k", x, xs)
    xr = _mix(p, "cmix_r", x, xs)
    k = torch.square(F.relu(xk @ p.cast("c_wk", dt)))
    r = torch.sigmoid(xr @ p.cast("c_wr", dt))
    return r * (k @ p.cast("c_wv", dt)), x[:, -1:]
