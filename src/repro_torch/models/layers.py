"""Shared layer primitives: norms, rotary embeddings (RoPE / M-RoPE),
GQA attention (full, query-chunked, decode), MLPs, embeddings.

The port of ``repro.models.layers``; ``REPRO_PERF_BASELINE=1`` gives its
baseline form where the JAX package has one (``perfflags``: H5).

Conventions
-----------
* parameters live in ``Params`` modules that keep the JAX package's
  names and ``(d_in, d_out)`` layout, at ``param_dtype`` (default f32),
  and are used in the activation dtype (default bf16).  ``Params.cast``
  holds each cast copy, so a bf16 model with f32 weights keeps one bf16
  copy of every weight beside it (``w.to(bf16)`` is deterministic; a
  cast per call would re-read the f32 weights on every step).  A
  parameter that requires grad is cast in the graph instead, while grad
  is enabled (training), so its gradient reaches the f32 weight.
* activations: (B, S, D).  Attention works on (B, S, Hkv, G, Dh) grouped
  heads so GQA never materializes repeated KV.
* KV caches store un-repeated KV heads: (B, S, Hkv, Dh).
* dtypes are explicit everywhere, as in the JAX package.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import perfflags
from ..parallel import sharding as shd
from .config import ModelConfig, dtype_of, pdtype_of, torch_dtype  # noqa: F401


class Params(nn.Module):
    """A nested dict of tensors as a module: tensors become parameters
    under their JAX names (frozen until training asks for their grads),
    dicts become sub-modules.

    ``p["wq"]`` reads a parameter, ``"bq" in p`` tests for one and
    ``p.cast("wq", dtype)`` gives it in ``dtype``: cast once and held
    until the parameter changes (a load or an optimizer step bumps its
    version; ``.to()`` clears the held copies), or, for a parameter that
    requires grad while grad is enabled, cast in the graph."""

    def __init__(self, tree: dict):
        super().__init__()
        self._casts = {}
        for name, val in tree.items():
            if isinstance(val, dict):
                self.add_module(name, Params(val))
            else:
                self.register_parameter(
                    name, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, name):
        return getattr(self, name)

    def __contains__(self, name):
        return name in self._parameters or name in self._modules

    def cast(self, name: str, dtype: torch.dtype) -> torch.Tensor:
        w = self._parameters[name]
        if w.dtype == dtype:
            return w
        if w.requires_grad and torch.is_grad_enabled():
            return w.to(dtype)
        held = self._casts.get((name, dtype))
        if held is None or held[0] != w._version:
            held = (w._version, w.detach().to(dtype))
            self._casts[(name, dtype)] = held
        return held[1]

    def _apply(self, fn, *args, **kwargs):
        self._casts = {}
        return super()._apply(fn, *args, **kwargs)


class Init:
    """Random initialisation from an explicit generator on ``device``
    (the JAX package's scales; not its PRNG stream)."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device,
                           dtype=torch.float32)

    def full(self, shape, value, dtype) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype, device=self.device)


# ----------------------------------------------------------------- init

def dense_init(init: Init, d_in, d_out, dtype, scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return (init.normal((d_in, d_out)) * scale).to(dtype)


# ----------------------------------------------------------------- norms

def rmsnorm(x, scale, eps=1e-6):
    """RMS statistics are an f32 sum of the products of the activation
    values; the normalisation multiplies in the activation dtype.  Under
    BASELINE (H5) the normalisation runs on an f32 copy of ``x``, with
    ``scale`` in f32 (pass the parameter, not its cast)."""
    if perfflags.BASELINE:
        xf = x.float()
        var = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps)
        return (out * scale.float()).to(x.dtype)
    xf = x.float()
    var = (xf * xf).sum(-1) / x.shape[-1]
    inv = torch.rsqrt(var + eps)[..., None].to(x.dtype)
    return x * inv * scale.to(x.dtype)


def layernorm(x, scale, bias, eps=1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def norm_params(cfg: ModelConfig, init: Init):
    pd = pdtype_of(cfg)
    d = (cfg.d_model,)
    if cfg.norm == "rmsnorm":
        return {"scale": init.full(d, 1.0, pd)}
    return {"scale": init.full(d, 1.0, pd), "bias": init.full(d, 0.0, pd)}


def apply_norm(cfg: ModelConfig, p: Params, x):
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["scale"] if perfflags.BASELINE
                       else p.cast("scale", x.dtype))
    return layernorm(x, p["scale"], p["bias"])


# ----------------------------------------------------------------- rotary

def _freqs(dim, theta, device):
    half = dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / float(half)))


def rope_angles(positions, dim, theta):
    """positions (..., S) int -> (..., S, dim//2) f32 angles."""
    return positions.float()[..., None] * _freqs(dim, theta, positions.device)


def apply_rope(x, angles):
    """x (B, S, ..., Dh); angles broadcastable to (B, S, 1, .., Dh//2).
    Dh splits into halves (not interleaved pairs)."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    cos = torch.cos(angles)
    sin = torch.sin(angles)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def mrope_angles(position_ids, dim, theta, sections):
    """M-RoPE (Qwen2-VL): position_ids (3, B, S); sections sum to dim//2.

    Each contiguous frequency section takes its angle from the matching
    positional stream (temporal / height / width).
    """
    half = dim // 2
    assert sum(sections) == half, (sections, half)
    dev = position_ids.device
    sec_id = torch.repeat_interleave(
        torch.arange(len(sections), device=dev),
        torch.tensor(sections, device=dev), output_size=half)
    p = position_ids.float().movedim(0, -1)                    # (B, S, 3)
    return p[..., sec_id] * _freqs(dim, theta, dev)            # (B, S, half)


# ----------------------------------------------------------------- attention

def qkv_params(cfg: ModelConfig, init: Init):
    d, hd = cfg.d_model, cfg.head_dim
    pd = pdtype_of(cfg)
    p = {
        "wq": dense_init(init, d, cfg.n_heads * hd, pd),
        "wk": dense_init(init, d, cfg.n_kv_heads * hd, pd),
        "wv": dense_init(init, d, cfg.n_kv_heads * hd, pd),
        "wo": dense_init(init, cfg.n_heads * hd, d, pd),
    }
    if cfg.qkv_bias:
        p["bq"] = init.full((cfg.n_heads * hd,), 0.0, pd)
        p["bk"] = init.full((cfg.n_kv_heads * hd,), 0.0, pd)
        p["bv"] = init.full((cfg.n_kv_heads * hd,), 0.0, pd)
    return p


def project_q(cfg: ModelConfig, p: Params, x, angles=None):
    """x (B, S, D) -> q (B, S, Hkv, G, Dh) alone (cross attention takes
    its keys and values from the encoder; the JAX package's compiler
    drops the unused projections)."""
    B, S, _ = x.shape
    dt = x.dtype
    q = shd.act(x @ p.cast("wq", dt), "logits")   # heads over "model"
    if cfg.qkv_bias:
        q = q + p.cast("bq", dt)
    q = q.reshape(B, S, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                  cfg.head_dim)
    if angles is not None:
        q = apply_rope(q, angles[:, :, None, None, :])
    return q


def project_qkv(cfg: ModelConfig, p: Params, x, angles=None):
    """x (B, S, D) -> q (B, S, Hkv, G, Dh), k/v (B, S, Hkv, Dh)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    hkv = cfg.n_kv_heads
    dt = x.dtype
    q = project_q(cfg, p, x, angles)
    k = x @ p.cast("wk", dt)
    v = x @ p.cast("wv", dt)
    if cfg.qkv_bias:
        k = k + p.cast("bk", dt)
        v = v + p.cast("bv", dt)
    k = k.reshape(B, S, hkv, hd)
    v = v.reshape(B, S, hkv, hd)
    if angles is not None:
        k = apply_rope(k, angles[:, :, None, :])
    return q, k, v


def _softmax_attend(q, k, v, mask, scale):
    """q (B,Sq,Hkv,G,Dh), k/v (B,Skv,Hkv,Dh), mask (Sq,Skv) or None."""
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype), v)


def causal_attention(cfg: ModelConfig, q, k, v, causal=True, chunk=None):
    """Full or query-chunked causal attention (chunks of ``chunk``
    queries when Sq > chunk and chunk divides Sq; the mask is
    tril(k = Skv - Sq))."""
    B, Sq, hkv, g, hd = q.shape
    Skv = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    chunk = chunk or cfg.attn_chunk
    dev = q.device
    if Sq <= chunk or Sq % chunk != 0:
        mask = None
        if causal:
            mask = torch.ones((Sq, Skv), dtype=torch.bool,
                              device=dev).tril(Skv - Sq)
        return _softmax_attend(q, k, v, mask, scale)
    pos_k = torch.arange(Skv, device=dev)
    outs = []
    for start in range(0, Sq, chunk):
        mask = None
        if causal:
            pos_q = start + torch.arange(chunk, device=dev)
            mask = pos_k[None, :] <= (pos_q[:, None] + (Skv - Sq))
        outs.append(_softmax_attend(q[:, start:start + chunk], k, v, mask,
                                    scale))
    return torch.cat(outs, dim=1)


KV_INT8_SCALE = 16.0  # fixed-point scale for int8 KV caches


def quantize_kv(x, cache_dtype):
    """KV -> cache dtype (int8 caches: x * 16 rounded half to even,
    clipped to +-127)."""
    if cache_dtype == torch.int8:
        return torch.clamp(torch.round(x.float() * KV_INT8_SCALE),
                           -127, 127).to(torch.int8)
    return x.to(cache_dtype)


def _dequant_kv(x):
    if x.dtype == torch.int8:
        return x.float() * (1.0 / KV_INT8_SCALE)
    return x.float()


def decode_attention(q, k_cache, v_cache, length):
    """Single-step attention against a cache.

    q (B, 1, Hkv, G, Dh); caches (B, S, Hkv, Dh); length: the valid
    prefix (an int or a 0-d tensor; positions past it get -1e30).  int8
    caches are dequantized at use.
    """
    S = k_cache.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.float(),
                          _dequant_kv(k_cache)) * scale
    valid = torch.arange(S, device=q.device) < length
    logits = logits.masked_fill(~valid, -1e30)
    w = torch.softmax(logits, dim=-1)
    vf = _dequant_kv(v_cache) if v_cache.dtype == torch.int8 else v_cache
    return torch.einsum("bhgqk,bkhd->bqhgd", w.to(vf.dtype), vf)


def attn_out(cfg: ModelConfig, p: Params, out):
    B, S = out.shape[0], out.shape[1]
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return out @ p.cast("wo", out.dtype)


# ----------------------------------------------------------------- mlp

def mlp_params(cfg: ModelConfig, init: Init, d_ff=None):
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    pd = pdtype_of(cfg)
    if cfg.mlp == "swiglu":
        return {
            "w_gate": dense_init(init, d, ff, pd),
            "w_up": dense_init(init, d, ff, pd),
            "w_down": dense_init(init, ff, d, pd),
        }
    return {
        "w_up": dense_init(init, d, ff, pd),
        "b_up": init.full((ff,), 0.0, pd),
        "w_down": dense_init(init, ff, d, pd),
        "b_down": init.full((d,), 0.0, pd),
    }


def apply_mlp(cfg: ModelConfig, p: Params, x):
    dt = x.dtype
    if cfg.mlp == "swiglu":
        gate = F.silu(x @ p.cast("w_gate", dt))
        up = x @ p.cast("w_up", dt)
        return (gate * up) @ p.cast("w_down", dt)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p.cast("w_up", dt) + p.cast("b_up", dt),
               approximate="tanh")
    return h @ p.cast("w_down", dt) + p.cast("b_down", dt)


# ----------------------------------------------------------------- embeddings

def embed_params(cfg: ModelConfig, init: Init):
    pd = pdtype_of(cfg)
    p = {"embedding": dense_init(init, cfg.vocab, cfg.d_model, pd,
                                 scale=0.02)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(init, cfg.d_model, cfg.vocab, pd)
    return p


def embed(cfg: ModelConfig, p: Params, tokens):
    return p["embedding"][tokens.long()].to(dtype_of(cfg))


def unembed(cfg: ModelConfig, p: Params, x):
    """Logits: the product in the activation dtype, then f32."""
    dt = x.dtype
    if cfg.tie_embeddings:
        return (x @ p.cast("embedding", dt).T).float()
    return (x @ p.cast("lm_head", dt)).float()


def sinusoidal_positions(S, d, dtype, device):
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, dim / float(d))
    pe = torch.zeros((S, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe.to(dtype)
