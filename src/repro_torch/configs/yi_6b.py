"""yi-6b [dense] 32L d=4096 32H (GQA kv=4) ff=11008 v=64000.

[arXiv:2403.04652; hf] llama-arch GQA.
"""
from repro_torch.models.config import ModelConfig
from repro_torch.configs import standard_cells

CONFIG = ModelConfig(
    name="yi-6b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=4, d_ff=11008, vocab=64000, rope_theta=5e6,
)

SMOKE = ModelConfig(
    name="yi-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=8, n_kv_heads=2, d_ff=160, vocab=512, attn_chunk=16,
)

CELLS = standard_cells(train_mb=4)
