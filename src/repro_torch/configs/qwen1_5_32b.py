"""qwen1.5-32b [dense] 64L d=5120 40H (kv=40) ff=27392 v=152064, QKV bias.

[hf:Qwen/Qwen1.5-0.5B; hf]
decode_32k uses the int8 KV cache (dequantized at use, DESIGN.md #6).
``decode_head_pad=48`` pads the 40 KV heads of the decode cache to 48
(the JAX package's 16-way model axis); the padded heads carry zeros.
"""
from repro_torch.models.config import ModelConfig
from repro_torch.configs import standard_cells

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=40, n_kv_heads=40, d_ff=27392, vocab=152064, qkv_bias=True,
    rope_theta=1e6, decode_head_pad=48,
)

SMOKE = ModelConfig(
    name="qwen32-smoke", family="dense", n_layers=2, d_model=80,
    n_heads=5, n_kv_heads=5, d_ff=224, vocab=512, qkv_bias=True,
    attn_chunk=16,
)

CELLS = standard_cells(train_mb=16, decode_kv_dtype="int8")
