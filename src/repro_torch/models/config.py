"""Model configuration shared by all assigned architectures.

The port's own copy of the JAX package's ``ModelConfig`` (same fields,
defaults and counts), plus the torch dtypes of its dtype names."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int8": torch.int8}


def torch_dtype(name) -> torch.dtype:
    """A dtype name (or a torch dtype) -> the torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}") from None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    mlp: str = "swiglu"          # swiglu | gelu
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    pos: str = "rope"            # rope | mrope | sinusoidal
    rope_theta: float = 1e4
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1           # MoE replaces the MLP every k-th layer
    d_ff_expert: int = 0         # expert hidden dim (defaults to d_ff)
    n_shared_experts: int = 0
    capacity_factor: float = 1.25

    # hybrid / ssm
    attn_every: int = 0          # jamba: 1 attention layer per this many
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    rwkv_head_dim: int = 64

    # enc-dec (audio)
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0

    # vlm
    mrope_sections: Tuple[int, ...] = ()

    # frontend stub: inputs arrive as precomputed embeddings
    embedding_inputs: bool = False

    dtype: str = "bfloat16"      # activation dtype
    param_dtype: str = "float32"
    opt_state_dtype: str = "float32"

    # decode KV-cache head padding: pad Hkv up to this count so the
    # cache head axis divides the model mesh axis (0 = off).  Padded
    # heads carry zero K/V/q and are sliced away after attention.
    decode_head_pad: int = 0

    # sequence-chunked attention threshold / chunk size
    attn_chunk: int = 1024
    scan_chunk: int = 64         # ssm/rwkv time-chunk

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def layer_kinds(self):
        """Per-layer (mixer, ffn) plan.

        mixer in {attn, mamba, rwkv}; ffn in {mlp, moe}.
        """
        kinds = []
        for i in range(self.n_layers):
            if self.family == "ssm":
                mixer = "rwkv"
            elif self.attn_every > 0:
                mixer = "attn" if i % self.attn_every == 0 else "mamba"
            else:
                mixer = "attn"
            if self.n_experts > 0 and (i % self.moe_every == self.moe_every - 1):
                ffn = "moe"
            else:
                ffn = "mlp"
            kinds.append((mixer, ffn))
        return kinds

    @property
    def supports_long_context(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, ff = self.d_model, self.d_ff
        hd = self.head_dim
        n = 2 * self.vocab * d if not self.tie_embeddings else self.vocab * d
        ffe = self.d_ff_expert or ff
        for mixer, ffn in self.layer_kinds:
            if mixer == "attn":
                n += d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            elif mixer == "mamba":
                di = self.mamba_expand * d
                dt_rank = max(d // 16, 1)
                n += d * 2 * di + di * self.mamba_d_conv
                n += di * (dt_rank + 2 * self.mamba_d_state) + dt_rank * di
                n += di * d + di * self.mamba_d_state + di
            else:  # rwkv
                n += 5 * d * d + d * d  # r,k,v,g,o + decay lora (approx)
            if ffn == "moe":
                n += self.n_experts * 3 * d * ffe + d * self.n_experts
                n += self.n_shared_experts * 3 * d * ffe
            else:
                mult = 3 if self.mlp == "swiglu" else 2
                n += mult * d * ff
        if self.is_encoder_decoder:
            # encoder blocks + decoder cross-attention
            n += self.n_enc_layers * (4 * d * d + (3 if self.mlp == "swiglu" else 2) * d * ff)
            n += self.n_layers * 4 * d * d
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.n_experts == 0:
            return self.param_count()
        d = self.d_model
        ffe = self.d_ff_expert or self.d_ff
        dense = self.param_count() - sum(
            self.n_experts * 3 * d * ffe
            for _, ffn in self.layer_kinds if ffn == "moe"
        )
        active_moe = sum(
            (self.top_k) * 3 * d * ffe
            for _, ffn in self.layer_kinds if ffn == "moe"
        )
        return dense + active_moe


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    """The activation dtype."""
    return torch_dtype(cfg.dtype)


def pdtype_of(cfg: ModelConfig) -> torch.dtype:
    """The dtype parameters are held in."""
    return torch_dtype(cfg.param_dtype)
