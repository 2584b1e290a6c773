"""jamba-1.5-large-398b [hybrid] 72L d=8192 64H (kv=8) ff=24576 v=65536,
MoE 16e top-2, Mamba:attn 7:1 interleave.

[arXiv:2403.19887; hf]
bf16 params and Adam moments; microbatch 16 (the JAX package's TPU
memory plan).  long_500k runs with the sequence-sharded KV cache for the
9 attention layers + O(1) Mamba states.
"""
from repro_torch.configs import CellSpec, standard_cells
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large", family="hybrid", n_layers=72, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=24576, vocab=65536,
    n_experts=16, top_k=2, moe_every=2, attn_every=8,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    param_dtype="bfloat16", opt_state_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid", n_layers=4, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    n_experts=4, top_k=2, moe_every=2, attn_every=4,
    mamba_d_state=4, mamba_d_conv=2, mamba_expand=2,
    scan_chunk=8, attn_chunk=16,
)

CELLS = standard_cells(train_mb=16, long_ok=True)
