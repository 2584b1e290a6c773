"""qwen1.5-0.5b [dense] 24L d=1024 16H (kv=16) ff=2816 v=151936, QKV bias.

[hf:Qwen/Qwen1.5-0.5B; hf]
"""
from repro_torch.models.config import ModelConfig
from repro_torch.configs import standard_cells

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=2816, vocab=151936, qkv_bias=True,
    tie_embeddings=True, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen0.5-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=96, vocab=512, qkv_bias=True,
    tie_embeddings=True, attn_chunk=16,
)

CELLS = standard_cells(train_mb=1)
