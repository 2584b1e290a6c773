"""rwkv6-3b [ssm] 32L d=2560 (attn-free) ff=8960 v=65536 -- Finch,
data-dependent decay.

[arXiv:2404.05892; hf]
long_500k runs natively: decode is an O(1) recurrence on a
(L, B, H, 64, 64) state; no KV cache exists.
"""
from repro_torch.configs import standard_cells
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm", n_layers=32, d_model=2560,
    n_heads=40, n_kv_heads=40, d_ff=8960, vocab=65536, rwkv_head_dim=64,
    scan_chunk=32,
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="ssm", n_layers=2, d_model=64,
    n_heads=2, n_kv_heads=2, d_ff=128, vocab=512, rwkv_head_dim=32,
    scan_chunk=8,
)

CELLS = standard_cells(train_mb=4, long_ok=True)
