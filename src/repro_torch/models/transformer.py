"""Model assembly for every assigned architecture family.

The port of ``repro.models.transformer``: four ``nn.Module`` classes
behind one API.

  DecoderLM  -- uniform [attn + (mlp|moe)] blocks: dense, moe, vlm(M-RoPE)
  HybridLM   -- Jamba super-blocks: groups of (1 attn + attn_every-1
                mamba) sublayers with MoE on every moe_every-th sublayer
  RWKVLM     -- RWKV6 (time-mix + channel-mix) blocks
  EncDecLM   -- Whisper-style encoder-decoder (stubbed conv frontend:
                inputs are precomputed frame embeddings)

API (the JAX package's, with the parameters held by the module):
  build_model(cfg, device=None, seed=0) -> model (random init)
  model.train_loss(batch) -> (loss f32, metrics dict)
  model.init_cache(batch_size, max_len, ...) -> cache dict
  model.prefill(batch) -> (last-position logits (B, 1, V) f32, cache)
  model.decode_step(batch, cache) -> (logits (B, 1, V) f32, cache)

Blocks are an ``nn.ModuleList`` (Jamba's super-blocks a list of groups)
where the JAX package stacks them for ``lax.scan``; the caches keep its
stacked layouts, e.g. (L, B, S, Hkv, Dh).  ``decode_step`` writes the new
position into the cache's tensors in place and returns the same dict with
``length`` advanced; ``length`` stays a 0-d int32 tensor on the device,
so a decode step never waits for the device.  A step past the cache's
last slot writes that slot again (the JAX package's
``dynamic_update_slice`` clamps the position the same way).

``train_loss`` recomputes each block (and each cross-entropy chunk) in
the backward pass, as the JAX package's ``jax.checkpoint`` bodies do, so
the saved activations are one (B, S, D) input per block.

Sharded execution: with parameters, batch and cache as DTensors on a
device mesh (``parallel.sharding.distribute_params``) the same code runs
over the mesh; ``shd.act`` places the hidden states, logits and caches
where the JAX package's ``shd.act`` sites constrain them.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import layers as L
from . import mamba as M
from . import moe as E
from . import rwkv as R
from ..parallel import sharding as shd
from .config import ModelConfig
from .layers import Init, Params


def _remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass
    (``jax.checkpoint``)."""
    return checkpoint(fn, *args, use_reentrant=False)


def _ce_sum(cfg: ModelConfig, embed_params, x, labels):
    """Summed negative log-likelihood of ``labels`` under the f32 logits
    of ``x`` (B, chunk, D)."""
    logits = shd.act(L.unembed(cfg, embed_params, x), "logits")
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.gather(logits, -1, labels[..., None].long())
    if shd.is_sharded(lab):
        # a gather over the vocab-sharded logits is a masked partial sum
        # whose mask keeps the gather's (B, chunk, 1) shape
        return (lse[..., None] - lab).sum()
    return (lse - lab[..., 0]).sum()


def chunked_ce_loss(cfg: ModelConfig, embed_params, x, labels, chunk=1024):
    """Mean cross-entropy over sequence chunks of ``chunk`` positions (the
    whole sequence when ``chunk`` does not divide it or covers it), each
    chunk's (B, chunk, V) logits recomputed in the backward pass."""
    B, S, _ = x.shape
    if S % chunk != 0 or S <= chunk:
        chunk = S
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, S, chunk):
        total = total + _remat(_ce_sum, cfg, embed_params,
                               x[:, start:start + chunk],
                               labels[:, start:start + chunk])
    return total / (B * S)


def _length(n: int, device) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int32, device=device)


def _pos_angles(cfg: ModelConfig, batch, S, device):
    if cfg.pos == "mrope":
        return L.mrope_angles(batch["position_ids"], cfg.head_dim,
                              cfg.rope_theta, cfg.mrope_sections)
    if cfg.pos == "rope":
        B = (batch["tokens"] if "tokens" in batch else batch["embeds"]).shape[0]
        pos = torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)
        return L.rope_angles(pos, cfg.head_dim, cfg.rope_theta)
    return None


def _step_angles(cfg: ModelConfig, pos, B):
    """Angles of the one position ``pos`` (0-d tensor) for a decode step."""
    if cfg.pos == "mrope":
        pid = pos.reshape(1, 1, 1).expand(3, B, 1)
        return L.mrope_angles(pid, cfg.head_dim, cfg.rope_theta,
                              cfg.mrope_sections)
    if cfg.pos == "rope":
        return L.rope_angles(pos.reshape(1, 1).expand(B, 1), cfg.head_dim,
                             cfg.rope_theta)
    return None


def _slot(pos, S):
    """The cache slot of position ``pos`` (0-d tensor): ``pos`` clamped to
    the last of ``S`` slots on the device."""
    return pos.clamp(max=S - 1).reshape(1).long()


def _write(cache_t, pos, new):
    """cache_t (B, S, ...) [:, pos] = new (B, 1, ...), in place; a ``pos``
    past the last slot writes the last slot.  A sharded cache takes the
    write into each rank's shard (the batch and head shards of ``new``
    are placed as the cache's)."""
    slot = _slot(pos, cache_t.shape[1])
    if shd.is_sharded(cache_t):
        new = new.redistribute(cache_t.device_mesh, cache_t.placements)
        cache_t.to_local().index_copy_(1, slot, new.to_local())
        return
    cache_t.index_copy_(1, slot, new)


class _LM(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return self.ln_f["scale"].device

    def _loss(self, x, batch, aux=None):
        """(CE + 0.01 * aux, metrics) of the backbone's output ``x``."""
        x = L.apply_norm(self.cfg, self.ln_f, x)
        ce = chunked_ce_loss(self.cfg, self.embed, x, batch["labels"])
        if aux is None:
            return ce, {"ce": ce}
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    def _inputs_embed(self, batch):
        cfg = self.cfg
        if cfg.embedding_inputs:
            x = batch["embeds"].to(L.dtype_of(cfg))
        else:
            x = L.embed(cfg, self.embed, batch["tokens"])
        if cfg.pos == "sinusoidal":
            x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model, x.dtype,
                                           x.device)[None]
        return shd.act(x, "hidden")

    def _head(self, x):
        x = L.apply_norm(self.cfg, self.ln_f, x)
        return L.unembed(self.cfg, self.embed, x)


def _ffn(cfg, bp: Params, h):
    """(the block's MLP or MoE output, MoE's auxiliary loss or None)."""
    if "moe" in bp:
        return E.apply_moe(cfg, bp["moe"], h)
    return L.apply_mlp(cfg, bp["mlp"], h), None


def _add_aux(total, aux):
    """total + aux, where either may be None (no MoE layer)."""
    if aux is None:
        return total
    return aux if total is None else total + aux


def _zero(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _ffn_params(cfg, init, moe: bool):
    if moe:
        return {"moe": E.moe_params(cfg, init)}
    return {"mlp": L.mlp_params(cfg, init)}


# =================================================================== DecoderLM

class DecoderLM(_LM):
    """Uniform decoder-only transformer (dense / moe / vlm)."""

    def __init__(self, cfg: ModelConfig, init: Init):
        super().__init__(cfg)
        self.embed = Params(L.embed_params(cfg, init))
        self.blocks = nn.ModuleList(
            Params(self._block_init(init)) for _ in range(cfg.n_layers))
        self.ln_f = Params(L.norm_params(cfg, init))

    def _block_init(self, init):
        cfg = self.cfg
        p = {"ln1": L.norm_params(cfg, init), "attn": L.qkv_params(cfg, init),
             "ln2": L.norm_params(cfg, init)}
        p.update(_ffn_params(cfg, init, bool(cfg.n_experts)))
        return p

    def _block(self, bp, x, angles):
        """One block over the whole sequence: (x, MoE aux or None, k, v)."""
        cfg = self.cfg
        h = L.apply_norm(cfg, bp["ln1"], x)
        q, k, v = L.project_qkv(cfg, bp["attn"], h, angles)
        x = x + L.attn_out(cfg, bp["attn"], L.causal_attention(cfg, q, k, v))
        x = shd.act(x, "hidden")
        h = L.apply_norm(cfg, bp["ln2"], x)
        ff, aux = _ffn(cfg, bp, h)
        return shd.act(x + ff, "hidden"), aux, k, v

    def train_loss(self, batch):
        x = self._inputs_embed(batch)
        angles = _pos_angles(self.cfg, batch, x.shape[1], x.device)
        aux = _zero(x)
        for bp in self.blocks:
            x, a, _, _ = _remat(self._block, bp, x, angles)
            aux = _add_aux(aux, a)
        return self._loss(x, batch, aux)

    def prefill(self, batch):
        x = self._inputs_embed(batch)
        angles = _pos_angles(self.cfg, batch, x.shape[1], x.device)
        ks, vs = [], []
        for bp in self.blocks:
            x, _, k, v = self._block(bp, x, angles)
            ks.append(k)
            vs.append(v)
        logits = self._head(x[:, -1:])
        return logits, {"k": shd.act(torch.stack(ks), "cache"),
                        "v": shd.act(torch.stack(vs), "cache"),
                        "length": _length(x.shape[1], x.device)}

    def init_cache(self, batch_size, max_len, dtype=None):
        cfg = self.cfg
        dt = L.torch_dtype(dtype) if dtype is not None else L.dtype_of(cfg)
        hkv = max(cfg.decode_head_pad, cfg.n_kv_heads)
        shape = (cfg.n_layers, batch_size, max_len, hkv, cfg.head_dim)
        dev = self.device
        return {"k": shd.act(torch.zeros(shape, dtype=dt, device=dev),
                             "cache"),
                "v": shd.act(torch.zeros(shape, dtype=dt, device=dev),
                             "cache"),
                "length": _length(0, dev)}

    def decode_step(self, batch, cache):
        """batch: tokens (B, 1) [or embeds]; the position is the cache's
        length."""
        cfg = self.cfg
        x = self._inputs_embed(batch)
        pos = cache["length"]
        angles = _step_angles(cfg, pos, x.shape[0])
        hkv_pad = max(cfg.decode_head_pad, cfg.n_kv_heads) - cfg.n_kv_heads
        for i, bp in enumerate(self.blocks):
            kc, vc = cache["k"][i], cache["v"][i]
            h = L.apply_norm(cfg, bp["ln1"], x)
            q, k, v = L.project_qkv(cfg, bp["attn"], h, angles)
            if hkv_pad:
                pad = (0, 0, 0, hkv_pad)
                k = torch.nn.functional.pad(k, pad)
                v = torch.nn.functional.pad(v, pad)
                q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, hkv_pad))
            _write(kc, pos, L.quantize_kv(k, kc.dtype))
            _write(vc, pos, L.quantize_kv(v, vc.dtype))
            att = L.decode_attention(q, kc, vc, pos + 1)
            if hkv_pad:
                att = att[:, :, :cfg.n_kv_heads]
            x = x + L.attn_out(cfg, bp["attn"], att.to(x.dtype))
            h = L.apply_norm(cfg, bp["ln2"], x)
            x = shd.act(x + _ffn(cfg, bp, h)[0], "hidden")
        cache["k"] = shd.act(cache["k"], "cache")
        cache["v"] = shd.act(cache["v"], "cache")
        cache["length"] = pos + 1
        return self._head(x), cache


# =================================================================== HybridLM

class HybridLM(_LM):
    """Jamba: super-blocks of `attn_every` sublayers (1 attn + rest mamba),
    MoE replacing the MLP on every `moe_every`-th sublayer."""

    def __init__(self, cfg: ModelConfig, init: Init):
        assert cfg.attn_every > 0 and cfg.n_layers % cfg.attn_every == 0
        super().__init__(cfg)
        self.group = cfg.attn_every
        self.n_groups = cfg.n_layers // cfg.attn_every
        self.embed = Params(L.embed_params(cfg, init))
        self.superblocks = nn.ModuleList(
            nn.ModuleList(Params(self._sub_init(init, i))
                          for i in range(self.group))
            for _ in range(self.n_groups))
        self.ln_f = Params(L.norm_params(cfg, init))

    def _is_moe(self, idx):
        cfg = self.cfg
        return idx % cfg.moe_every == cfg.moe_every - 1

    def _sub_init(self, init, idx):
        cfg = self.cfg
        p = {"ln1": L.norm_params(cfg, init), "ln2": L.norm_params(cfg, init)}
        if idx == 0:
            p["attn"] = L.qkv_params(cfg, init)
        else:
            p["mamba"] = M.mamba_params(cfg, init)
        p.update(_ffn_params(cfg, init, self._is_moe(idx)))
        return p

    def _group(self, gp, x, angles):
        """One super-block over the whole sequence: (x, its sub-layers'
        summed MoE aux or None, the attention's k, v, the Mamba layers'
        stacked conv and ssm states)."""
        cfg = self.cfg
        aux = None
        convs, ssms = [], []
        for i, sp in enumerate(gp):
            h = L.apply_norm(cfg, sp["ln1"], x)
            if i == 0:
                q, k, v = L.project_qkv(cfg, sp["attn"], h, angles)
                x = x + L.attn_out(cfg, sp["attn"],
                                   L.causal_attention(cfg, q, k, v))
            else:
                out, st = M.mamba_forward(cfg, sp["mamba"], h,
                                          return_state=True)
                x = x + out
                convs.append(st["conv"])
                ssms.append(st["ssm"])
            x = shd.act(x, "hidden")
            h = L.apply_norm(cfg, sp["ln2"], x)
            ff, a = _ffn(cfg, sp, h)
            x = shd.act(x + ff, "hidden")
            aux = _add_aux(aux, a)
        return x, aux, k, v, torch.stack(convs), torch.stack(ssms)

    def train_loss(self, batch):
        x = self._inputs_embed(batch)
        angles = _pos_angles(self.cfg, batch, x.shape[1], x.device)
        aux = _zero(x)
        for gp in self.superblocks:
            x, a, *_ = _remat(self._group, gp, x, angles)
            aux = _add_aux(aux, a)
        return self._loss(x, batch, aux)

    def init_cache(self, batch_size, max_len, dtype=None):
        cfg = self.cfg
        dt = L.torch_dtype(dtype) if dtype is not None else L.dtype_of(cfg)
        di = M.d_inner(cfg)
        dev = self.device
        kv_shape = (self.n_groups, batch_size, max_len, cfg.n_kv_heads,
                    cfg.head_dim)
        return {
            "k": shd.act(torch.zeros(kv_shape, dtype=dt, device=dev),
                         "cache"),
            "v": shd.act(torch.zeros(kv_shape, dtype=dt, device=dev),
                         "cache"),
            "conv": shd.act(torch.zeros(
                (self.n_groups, self.group - 1, batch_size,
                 cfg.mamba_d_conv - 1, di), dtype=dt, device=dev), "hidden"),
            "ssm": shd.act(torch.zeros(
                (self.n_groups, self.group - 1, batch_size, di,
                 cfg.mamba_d_state), dtype=torch.float32, device=dev),
                "hidden"),
            "length": _length(0, dev),
        }

    def prefill(self, batch):
        x = self._inputs_embed(batch)
        angles = _pos_angles(self.cfg, batch, x.shape[1], x.device)
        ks, vs, convs, ssms = [], [], [], []
        for gp in self.superblocks:
            x, _, k, v, conv, ssm = self._group(gp, x, angles)
            ks.append(k)
            vs.append(v)
            convs.append(conv)
            ssms.append(ssm)
        logits = self._head(x[:, -1:])
        return logits, {"k": shd.act(torch.stack(ks), "cache"),
                        "v": shd.act(torch.stack(vs), "cache"),
                        "conv": torch.stack(convs), "ssm": torch.stack(ssms),
                        "length": _length(x.shape[1], x.device)}

    def decode_step(self, batch, cache):
        cfg = self.cfg
        x = self._inputs_embed(batch)
        pos = cache["length"]
        angles = L.rope_angles(pos.reshape(1, 1).expand(x.shape[0], 1),
                               cfg.head_dim, cfg.rope_theta)
        for g, gp in enumerate(self.superblocks):
            for i, sp in enumerate(gp):
                h = L.apply_norm(cfg, sp["ln1"], x)
                if i == 0:
                    kc, vc = cache["k"][g], cache["v"][g]
                    q, k, v = L.project_qkv(cfg, sp["attn"], h, angles)
                    _write(kc, pos, L.quantize_kv(k, kc.dtype))
                    _write(vc, pos, L.quantize_kv(v, vc.dtype))
                    att = L.decode_attention(q, kc, vc, pos + 1)
                    x = x + L.attn_out(cfg, sp["attn"], att.to(x.dtype))
                else:
                    st = {"conv": cache["conv"][g, i - 1],
                          "ssm": cache["ssm"][g, i - 1]}
                    out, st2 = M.mamba_decode_step(cfg, sp["mamba"], h, st)
                    st["conv"].copy_(st2["conv"])
                    st["ssm"].copy_(st2["ssm"])
                    x = x + out
                h = L.apply_norm(cfg, sp["ln2"], x)
                x = shd.act(x + _ffn(cfg, sp, h)[0], "hidden")
        cache["length"] = pos + 1
        return self._head(x), cache


# =================================================================== RWKVLM

class RWKVLM(_LM):
    def __init__(self, cfg: ModelConfig, init: Init):
        super().__init__(cfg)
        self.embed = Params(L.embed_params(cfg, init))
        self.blocks = nn.ModuleList(
            Params({"ln1": L.norm_params(cfg, init),
                    "ln2": L.norm_params(cfg, init),
                    "rwkv": R.rwkv_params(cfg, init)})
            for _ in range(cfg.n_layers))
        self.ln_f = Params(L.norm_params(cfg, init))

    def _block(self, bp, x):
        """One block over the whole sequence: (x, the final WKV state, the
        time-mix and channel-mix inputs of the last position)."""
        cfg = self.cfg
        h = L.apply_norm(cfg, bp["ln1"], x)
        tm, s_fin, lx = R.time_mix(cfg, bp["rwkv"], h)
        x = x + tm
        h2 = L.apply_norm(cfg, bp["ln2"], x)
        cm, lcx = R.channel_mix(cfg, bp["rwkv"], h2)
        return shd.act(x + cm, "hidden"), s_fin, lx, lcx

    def train_loss(self, batch):
        x = self._inputs_embed(batch)
        for bp in self.blocks:
            x, *_ = _remat(self._block, bp, x)
        return self._loss(x, batch)

    def init_cache(self, batch_size, max_len=0, dtype=None):
        cfg = self.cfg
        H = R.n_heads(cfg)
        hd = cfg.rwkv_head_dim
        dt = L.torch_dtype(dtype) if dtype is not None else L.dtype_of(cfg)
        Lc = cfg.n_layers
        dev = self.device
        x_shape = (Lc, batch_size, 1, cfg.d_model)
        return {
            "wkv": shd.act(torch.zeros((Lc, batch_size, H, hd, hd),
                                       dtype=torch.float32, device=dev),
                           "state"),
            "tm_x": torch.zeros(x_shape, dtype=dt, device=dev),
            "cm_x": torch.zeros(x_shape, dtype=dt, device=dev),
            "length": _length(0, dev),
        }

    def prefill(self, batch):
        """Forward over the prompt carrying states (chunked recurrence)."""
        x = self._inputs_embed(batch)
        wkv, tm_x, cm_x = [], [], []
        for bp in self.blocks:
            x, s_fin, lx, lcx = self._block(bp, x)
            wkv.append(s_fin)
            tm_x.append(lx)
            cm_x.append(lcx)
        logits = self._head(x[:, -1:])
        return logits, {"wkv": torch.stack(wkv), "tm_x": torch.stack(tm_x),
                        "cm_x": torch.stack(cm_x),
                        "length": _length(x.shape[1], x.device)}

    def decode_step(self, batch, cache):
        cfg = self.cfg
        x = self._inputs_embed(batch)
        for i, bp in enumerate(self.blocks):
            h = L.apply_norm(cfg, bp["ln1"], x)
            tm, wkv2, lx = R.time_mix_decode(cfg, bp["rwkv"], h,
                                             cache["wkv"][i], cache["tm_x"][i])
            x = x + tm
            h2 = L.apply_norm(cfg, bp["ln2"], x)
            cm, lcx = R.channel_mix(cfg, bp["rwkv"], h2, cache["cm_x"][i])
            x = x + cm
            cache["wkv"][i].copy_(wkv2)
            cache["tm_x"][i].copy_(lx)
            cache["cm_x"][i].copy_(lcx)
        cache["length"] = cache["length"] + 1
        return self._head(x), cache


# =================================================================== EncDecLM

class EncDecLM(_LM):
    """Whisper-style enc-dec backbone.  Encoder inputs are precomputed
    frame embeddings (conv frontend stub), sinusoidal positions."""

    def __init__(self, cfg: ModelConfig, init: Init):
        super().__init__(cfg)
        self.embed = Params(L.embed_params(cfg, init))
        self.enc_blocks = nn.ModuleList(
            Params({"ln1": L.norm_params(cfg, init),
                    "attn": L.qkv_params(cfg, init),
                    "ln2": L.norm_params(cfg, init),
                    "mlp": L.mlp_params(cfg, init)})
            for _ in range(cfg.n_enc_layers))
        self.dec_blocks = nn.ModuleList(
            Params({"ln1": L.norm_params(cfg, init),
                    "self_attn": L.qkv_params(cfg, init),
                    "ln_x": L.norm_params(cfg, init),
                    "cross_attn": L.qkv_params(cfg, init),
                    "ln2": L.norm_params(cfg, init),
                    "mlp": L.mlp_params(cfg, init)})
            for _ in range(cfg.n_layers))
        self.ln_enc = Params(L.norm_params(cfg, init))
        self.ln_f = Params(L.norm_params(cfg, init))

    def _enc_block(self, bp, x):
        cfg = self.cfg
        h = L.apply_norm(cfg, bp["ln1"], x)
        q, k, v = L.project_qkv(cfg, bp["attn"], h)
        att = L.causal_attention(cfg, q, k, v, causal=False)
        x = x + L.attn_out(cfg, bp["attn"], att)
        h = L.apply_norm(cfg, bp["ln2"], x)
        return shd.act(x + L.apply_mlp(cfg, bp["mlp"], h), "hidden")

    def encode(self, frames, remat=False):
        """The encoder's output; ``remat`` recomputes each block in the
        backward pass (``train_loss``)."""
        cfg = self.cfg
        x = frames.to(L.dtype_of(cfg))
        x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model, x.dtype,
                                       x.device)[None]
        x = shd.act(x, "hidden")
        for bp in self.enc_blocks:
            x = _remat(self._enc_block, bp, x) if remat \
                else self._enc_block(bp, x)
        return L.apply_norm(cfg, self.ln_enc, x)

    def _dec_block(self, bp, x, enc_out):
        """A decoder block over the whole token sequence (causal self
        attention, cross attention to ``enc_out``): (x, k, v, the cross
        attention's ek, ev)."""
        cfg = self.cfg
        ek, ev = self._cross_kv(bp, enc_out)
        h = L.apply_norm(cfg, bp["ln1"], x)
        q, k, v = L.project_qkv(cfg, bp["self_attn"], h)
        att = L.causal_attention(cfg, q, k, v, causal=True)
        x = x + L.attn_out(cfg, bp["self_attn"], att)
        h = L.apply_norm(cfg, bp["ln_x"], x)
        q = L.project_q(cfg, bp["cross_attn"], h)
        att = L.causal_attention(cfg, q, ek, ev, causal=False)
        x = x + L.attn_out(cfg, bp["cross_attn"], att)
        h = L.apply_norm(cfg, bp["ln2"], x)
        return shd.act(x + L.apply_mlp(cfg, bp["mlp"], h), "hidden"), \
            k, v, ek, ev

    def train_loss(self, batch):
        cfg = self.cfg
        enc_out = self.encode(batch["frames"], remat=True)
        x = L.embed(cfg, self.embed, batch["tokens"])
        x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model, x.dtype,
                                       x.device)[None]
        for bp in self.dec_blocks:
            x, *_ = _remat(self._dec_block, bp, x, enc_out)
        return self._loss(x, batch)

    def _cross_kv(self, bp, enc_out):
        """The encoder output's cross-attention K/V (no bias)."""
        cfg = self.cfg
        ca = bp["cross_attn"]
        heads = (cfg.n_kv_heads, cfg.head_dim)
        return shd.unflatten(enc_out @ ca.cast("wk", enc_out.dtype), 2,
                             heads), \
            shd.unflatten(enc_out @ ca.cast("wv", enc_out.dtype), 2, heads)

    def init_cache(self, batch_size, max_len, enc_len, dtype=None):
        cfg = self.cfg
        dt = L.torch_dtype(dtype) if dtype is not None else L.dtype_of(cfg)
        dev = self.device

        def mk(s):
            return shd.act(torch.zeros((cfg.n_layers, batch_size, s,
                                        cfg.n_kv_heads, cfg.head_dim),
                                       dtype=dt, device=dev), "cache")

        return {"k": mk(max_len), "v": mk(max_len), "ek": mk(enc_len),
                "ev": mk(enc_len), "length": _length(0, dev)}

    def prefill(self, batch):
        """Encode frames, project cross-KV, run decoder prompt."""
        cfg = self.cfg
        enc_out = self.encode(batch["frames"])
        x = L.embed(cfg, self.embed, batch["tokens"])
        x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model, x.dtype,
                                       x.device)[None]
        ks, vs, eks, evs = [], [], [], []
        for bp in self.dec_blocks:
            x, k, v, ek, ev = self._dec_block(bp, x, enc_out)
            ks.append(k)
            vs.append(v)
            eks.append(ek)
            evs.append(ev)
        logits = self._head(x[:, -1:])
        return logits, {"k": torch.stack(ks), "v": torch.stack(vs),
                        "ek": torch.stack(eks), "ev": torch.stack(evs),
                        "length": _length(x.shape[1], x.device)}

    def decode_step(self, batch, cache):
        cfg = self.cfg
        x = L.embed(cfg, self.embed, batch["tokens"])
        pos = cache["length"]
        pe_table = L.sinusoidal_positions(cache["k"].shape[2], cfg.d_model,
                                          x.dtype, x.device)
        x = x + pe_table.index_select(0, _slot(pos, pe_table.shape[0]))[None]
        for i, bp in enumerate(self.dec_blocks):
            kc, vc = cache["k"][i], cache["v"][i]
            ek, ev = cache["ek"][i], cache["ev"][i]
            h = L.apply_norm(cfg, bp["ln1"], x)
            q, k, v = L.project_qkv(cfg, bp["self_attn"], h)
            _write(kc, pos, L.quantize_kv(k, kc.dtype))
            _write(vc, pos, L.quantize_kv(v, vc.dtype))
            att = L.decode_attention(q, kc, vc, pos + 1)
            x = x + L.attn_out(cfg, bp["self_attn"], att.to(x.dtype))
            h = L.apply_norm(cfg, bp["ln_x"], x)
            q = L.project_q(cfg, bp["cross_attn"], h)
            att = L.decode_attention(q, ek, ev, ek.shape[1])
            x = x + L.attn_out(cfg, bp["cross_attn"], att.to(x.dtype))
            h = L.apply_norm(cfg, bp["ln2"], x)
            x = x + L.apply_mlp(cfg, bp["mlp"], h)
        cache["length"] = pos + 1
        return self._head(x), cache


def build_model(cfg: ModelConfig, device=None, seed: int = 0):
    """The architecture's model, randomly initialised from ``seed`` by a
    generator on ``device`` (None: the CUDA device; RuntimeError without
    one)."""
    from ..core.compressor import resolve_device

    init = Init(seed, resolve_device(device))
    if cfg.is_encoder_decoder:
        return EncDecLM(cfg, init)
    if cfg.family == "ssm":
        return RWKVLM(cfg, init)
    if cfg.attn_every > 0:
        return HybridLM(cfg, init)
    return DecoderLM(cfg, init)
