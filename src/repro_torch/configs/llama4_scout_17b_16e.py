"""llama4-scout-17b-a16e [moe] 48L d=5120 40H (kv=8) ff=8192 v=202048,
MoE 16e top-1 + 1 shared expert.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
Early-fusion vision frontend is irrelevant to the text cells (stub);
iRoPE interleaving simplified to uniform RoPE (DESIGN.md).
"""
from repro_torch.models.config import ModelConfig
from repro_torch.configs import standard_cells

CONFIG = ModelConfig(
    name="llama4-scout-17b-16e", family="moe", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=8192, vocab=202048,
    n_experts=16, top_k=1, n_shared_experts=1, d_ff_expert=8192,
    rope_theta=5e5,
)

SMOKE = ModelConfig(
    name="llama4-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    n_experts=4, top_k=1, n_shared_experts=1, d_ff_expert=128,
    attn_chunk=16,
)

CELLS = standard_cells(train_mb=16)
