"""whisper-small [audio] 12+12L d=768 12H (kv=12) ff=3072 v=51865 --
enc-dec, conv frontend stubbed (input_specs feeds frame embeddings).

[arXiv:2212.04356; unverified]
Cell semantics: seq_len applies to the *encoder* (audio frames); the
decoder prompt is 448 tokens (Whisper's max).  decode_32k = one decoder
step against 32k cross-attention memory.  long_500k skipped (full
attention).
"""
from repro_torch.configs import CellSpec
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3072, vocab=51865,
    is_encoder_decoder=True, n_enc_layers=12, mlp="gelu",
    norm="layernorm", pos="sinusoidal",
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    is_encoder_decoder=True, n_enc_layers=2, mlp="gelu",
    norm="layernorm", pos="sinusoidal", attn_chunk=16,
)

CELLS = {
    "train_4k": CellSpec("train", 4096, 256, microbatches=2, dec_len=448),
    "prefill_32k": CellSpec("prefill", 32768, 32, dec_len=448),
    "decode_32k": CellSpec("decode", 32768, 128, cache_len=448,
                           enc_len=32768),
    "long_500k": CellSpec(
        "decode", 524288, 1, cache_len=448, enc_len=524288,
        skip="full quadratic attention arch: 500k decode excluded per "
             "assignment (sub-quadratic archs only)",
    ),
}
