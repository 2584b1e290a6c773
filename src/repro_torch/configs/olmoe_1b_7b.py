"""olmoe-1b-7b [moe] 16L d=2048 16H (kv=16) ff=1024 v=50304,
MoE 64e top-8.

[arXiv:2409.02060; hf]
"""
from repro_torch.models.config import ModelConfig
from repro_torch.configs import standard_cells

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe", n_layers=16, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1024, vocab=50304,
    n_experts=64, top_k=8, d_ff_expert=1024, rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="olmoe-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=64, vocab=512,
    n_experts=8, top_k=2, d_ff_expert=64, attn_chunk=16,
)

CELLS = standard_cells(train_mb=2)
