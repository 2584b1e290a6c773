"""Assigned-architecture registry and (arch x shape) cell definitions.

Every architecture module exposes:
  CONFIG  -- the exact published configuration
  SMOKE   -- a reduced same-family config for CPU tests
  CELLS   -- shape-name -> CellSpec (or a skip reason)

``input_specs(cfg, cell)`` builds stand-ins for every model input of a
cell: tensors on the ``meta`` device, with the JAX package's shapes and
dtypes, that allocate nothing.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

import torch

from ..models.config import ModelConfig

SHAPE_TABLE = {
    "train_4k": (4096, 256),
    "prefill_32k": (32768, 32),
    "decode_32k": (32768, 128),
    "long_500k": (524288, 1),
}

ARCHS = [
    "stablelm_1_6b",
    "qwen1_5_0_5b",
    "yi_6b",
    "qwen1_5_32b",
    "jamba_1_5_large",
    "llama4_scout_17b_16e",
    "olmoe_1b_7b",
    "rwkv6_3b",
    "whisper_small",
    "qwen2_vl_7b",
]


@dataclasses.dataclass(frozen=True)
class CellSpec:
    kind: str                      # train | prefill | decode
    seq_len: int
    global_batch: int
    microbatches: int = 1
    cache_len: int = 0             # decode: prefilled KV length
    kv_dtype: str = "bfloat16"     # decode KV cache dtype (int8 for 32B)
    seq_sharded_cache: bool = False
    enc_len: int = 0               # enc-dec: encoder length
    dec_len: int = 448             # enc-dec: decoder token length
    skip: str = ""                 # non-empty -> cell skipped, with reason


def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, cell: CellSpec) -> dict:
    """Meta-tensor batch for a cell (cache built separately)."""
    B, S = cell.global_batch, cell.seq_len
    i32 = torch.int32
    if cfg.is_encoder_decoder:
        if cell.kind == "train":
            return {
                "frames": _sds((B, S, cfg.d_model), torch.float32),
                "tokens": _sds((B, cell.dec_len), i32),
                "labels": _sds((B, cell.dec_len), i32),
            }
        if cell.kind == "prefill":
            return {
                "frames": _sds((B, S, cfg.d_model), torch.float32),
                "tokens": _sds((B, cell.dec_len), i32),
            }
        return {"tokens": _sds((B, 1), i32)}
    if cfg.embedding_inputs:
        if cell.kind == "train":
            return {
                "embeds": _sds((B, S, cfg.d_model), torch.bfloat16),
                "position_ids": _sds((3, B, S), i32),
                "labels": _sds((B, S), i32),
            }
        if cell.kind == "prefill":
            return {
                "embeds": _sds((B, S, cfg.d_model), torch.bfloat16),
                "position_ids": _sds((3, B, S), i32),
            }
        return {"embeds": _sds((B, 1, cfg.d_model), torch.bfloat16)}
    if cell.kind == "train":
        return {"tokens": _sds((B, S), i32), "labels": _sds((B, S), i32)}
    if cell.kind == "prefill":
        return {"tokens": _sds((B, S), i32)}
    return {"tokens": _sds((B, 1), i32)}


def standard_cells(
    train_mb: int,
    *,
    long_ok: bool = False,
    decode_kv_dtype: str = "bfloat16",
    prefill_skip: str = "",
) -> Dict[str, CellSpec]:
    """The default 4-cell table for decoder LMs."""
    s = SHAPE_TABLE
    cells = {
        "train_4k": CellSpec("train", *s["train_4k"], microbatches=train_mb),
        "prefill_32k": CellSpec("prefill", *s["prefill_32k"], skip=prefill_skip),
        "decode_32k": CellSpec(
            "decode", 32768, s["decode_32k"][1], cache_len=32768,
            kv_dtype=decode_kv_dtype,
        ),
    }
    if long_ok:
        cells["long_500k"] = CellSpec(
            "decode", 524288, 1, cache_len=524288, seq_sharded_cache=True
        )
    else:
        cells["long_500k"] = CellSpec(
            "decode", 524288, 1, cache_len=524288,
            skip="full quadratic attention arch: 500k decode excluded per "
                 "assignment (sub-quadratic archs only)",
        )
    return cells


_loaded: Dict[str, object] = {}


def get(name: str):
    key = name.replace("-", "_").replace(".", "_")
    if key not in _loaded:
        _loaded[key] = importlib.import_module(f"repro_torch.configs.{key}")
    return _loaded[key]


def all_archs():
    return [get(a) for a in ARCHS]
