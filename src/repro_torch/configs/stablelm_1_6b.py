"""stablelm-1.6b [dense] 24L d=2048 32H (kv=32) ff=5632 v=100352.

[hf:stabilityai/stablelm-2-1_6b; unverified]
Simplifications vs HF: full-dim RoPE (upstream uses 25% partial rotary)
and RMSNorm (upstream LayerNorm) -- noted in DESIGN.md.
"""
from repro_torch.models.config import ModelConfig
from repro_torch.configs import standard_cells

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense", n_layers=24, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=5632, vocab=100352, rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="stablelm-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=160, vocab=512, attn_chunk=16,
)

CELLS = standard_cells(train_mb=2)
