"""qwen2-vl-7b [vlm] 28L d=3584 28H (GQA kv=4) ff=18944 v=152064 --
M-RoPE, dynamic resolution (patch frontend stubbed: input_specs provides
precomputed patch/text embeddings + 3-stream position ids).

[arXiv:2409.12191; hf]
"""
from repro_torch.models.config import ModelConfig
from repro_torch.configs import standard_cells

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm", n_layers=28, d_model=3584,
    n_heads=28, n_kv_heads=4, d_ff=18944, vocab=152064, qkv_bias=True,
    pos="mrope", mrope_sections=(16, 24, 24), embedding_inputs=True,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen2vl-smoke", family="vlm", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=512, qkv_bias=True,
    pos="mrope", mrope_sections=(4, 2, 2), embedding_inputs=True,
    attn_chunk=16,
)

CELLS = standard_cells(train_mb=8)
