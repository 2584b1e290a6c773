"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: its row
has the JAX package's keys (``trace_s`` in place of ``lower_s`` /
``compile_s``, and the port's eager and workload bytes beside them), a
fake-tensor trace of a SMOKE step counts what the same step on real CPU
tensors counts (flops, eager and workload bytes, every op, the peak
allocation), ``resident_bytes`` covers the arguments, the CLI runs a
full-width cell in-process, and the sharded meshes ``single`` (16, 16)
and ``multi`` (2, 16, 16) trace the reference's tiny-mesh cell
(qwen1.5-0.5b ``decode_32k``, ``tests/test_roofline_dryrun.py``) in a
child process on a fake process group: per-device dot flops times the
mesh size equal the card's (batch and heads divide both meshes) and
collectives move bytes."""
import pytest

pytest.importorskip("torch")

import contextlib
import json

import torch

import repro_torch.configs as TC
from repro import roofline as JR
from repro_torch import roofline as TR
from repro_torch.configs import CellSpec
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.transformer import build_model

from test_torch_lm_common import _one_torch_thread  # noqa: F401

# small steps of each kind: micro-batches 2, query-chunked prefill and
# Mamba / RWKV scan chunks (SMOKE attn_chunk 16, scan_chunk 8)
CELLS = {"train": CellSpec("train", 32, 2, microbatches=2),
         "prefill": CellSpec("prefill", 32, 2, dec_len=8),
         "decode": CellSpec("decode", 32, 2, cache_len=40, enc_len=32)}
ARCHS = ["stablelm_1_6b", "olmoe_1b_7b", "jamba_1_5_large", "rwkv6_3b",
         "whisper_small", "qwen2_vl_7b"]
# the train step of one family (the SMOKE backward is the slow part):
# M-RoPE with embedding inputs and micro-batches
TRACE_CASES = [(a, k) for a in ARCHS for k in ("prefill", "decode")] \
    + [("qwen2_vl_7b", "train")]


def _trace(arch, kind, fake):
    cfg = TC.get(arch).SMOKE
    with D.fake_tensors() if fake else contextlib.nullcontext():
        model = build_model(cfg, device="cpu")
        fn, args = D.make_step(model, CELLS[kind], "cpu")
        cost, raw, out = D.trace(fn)
        mem = TR.memory_report(cost, args, D._tensors(out))
        mem["workload"] = TR.workload_bytes(cost, args, D._tensors(out))
    return cost, raw, mem


def test_row_keys_equal_reference():
    ref = JR.Roofline(arch="a", shape="s", mesh="m", n_chips=1,
                      flops_per_device=1.0, bytes_per_device=1.0,
                      coll_bytes_per_device=0.0, coll_breakdown={},
                      model_flops=1.0, memory_report={}).row()
    # the keys the reference's lower_cell adds to Roofline.row()
    want = set(ref) | {"status", "kind", "lower_s", "compile_s"}
    mod = TC.get("qwen1_5_0_5b")
    smoke = type("Smoke", (), {"CONFIG": mod.SMOKE, "CELLS": {
        "decode": CellSpec("decode", 32, 2, cache_len=32)}})
    row = D.lower_cell(smoke, "decode", D.card_mesh(), "card", "cpu")
    assert set(row) == want - {"lower_s", "compile_s"} | {
        "trace_s", "eager_bytes_per_device", "workload_bytes_per_device",
        "t_memory_workload_s", "workload_bottleneck"}
    assert 0 < row["workload_bytes_per_device"] \
        < row["eager_bytes_per_device"]
    assert row["status"] == "ok" and row["chips"] == 1
    mem = row["memory"]
    assert set(mem) == {"argument_size_in_bytes", "output_size_in_bytes",
                        "temp_size_in_bytes", "alias_size_in_bytes",
                        "resident_bytes"}
    assert mem["resident_bytes"] >= mem["argument_size_in_bytes"] > 0
    # the decode step writes the KV cache in place and gives it back
    assert mem["alias_size_in_bytes"] >= 2 * 2 * 32 * mod.SMOKE.n_layers \
        * mod.SMOKE.n_kv_heads * mod.SMOKE.head_dim * 2


@pytest.mark.parametrize("arch,kind", TRACE_CASES)
def test_fake_trace_equals_real_trace(arch, kind):
    fake_cost, fake_raw, fake_mem = _trace(arch, kind, True)
    real_cost, real_raw, real_mem = _trace(arch, kind, False)
    assert fake_cost.op_counts == real_cost.op_counts
    assert fake_cost.flops == real_cost.flops
    assert fake_cost.eager_bytes == real_cost.eager_bytes
    assert fake_cost.nondot_flops == real_cost.nondot_flops
    assert fake_cost.peak_bytes == real_cost.peak_bytes
    assert fake_raw == real_raw
    assert fake_mem == real_mem
    assert fake_mem["resident_bytes"] >= fake_mem["argument_size_in_bytes"]
    if kind == "train":
        # params and Adam moments are updated in place and given back:
        # the workload reads and writes each once
        assert fake_mem["alias_size_in_bytes"] \
            >= 3 * sum(p.numel() * 4 for p in build_model(
                TC.get(arch).SMOKE, device="cpu").parameters())
        assert fake_mem["workload"] >= 2 * fake_mem["alias_size_in_bytes"]


def test_cli_runs_a_full_width_cell(capsys):
    argv = ["--arch", "qwen1_5_0_5b", "--shape", "decode_32k", "--mesh",
            "card", "--device", "cpu"]
    assert D.main(argv) == 0
    out = capsys.readouterr().out
    assert "[dryrun] 1 ok, 0 skip, 0 fail" in out
    assert "qwen1.5-0.5b" in out and "decode_32k" in out


def test_skipped_cell_is_a_skip(capsys):
    assert D.main(["--arch", "yi_6b", "--shape", "long_500k",
                   "--device", "cpu"]) == 0
    assert "[dryrun] 0 ok, 1 skip, 0 fail" in capsys.readouterr().out


@pytest.fixture(scope="module")
def card_cost():
    """The OpCost of qwen1.5-0.5b ``decode_32k`` on the card mesh."""
    mod = TC.get("qwen1_5_0_5b")
    with D.fake_tensors():
        model = build_model(mod.CONFIG, device="cpu")
        fn, _ = D.make_step(model, mod.CELLS["decode_32k"], "cpu")
        cost, _, _ = D.trace(fn)
    return cost


@pytest.mark.parametrize("mesh", ["single", "multi", "both"])
def test_sharded_meshes(mesh, tmp_path, capsys, card_cost):
    """``single`` and ``multi``: the tiny-mesh cell, traced in a child
    process.  ``both``: a cell that is a skip on both meshes (its
    argument handling; a traced cell is the other two cases)."""
    out = str(tmp_path / "rows.json")
    if mesh == "both":
        assert D.main(["--arch", "yi_6b", "--shape", "long_500k", "--mesh",
                       "both", "--device", "cpu", "--out", out]) == 0
        assert "[dryrun] 0 ok, 2 skip, 0 fail" in capsys.readouterr().out
        with open(out) as f:
            assert [r["mesh"] for r in json.load(f)] == ["single", "multi"]
        return
    assert D.main(["--arch", "qwen1_5_0_5b", "--shape", "decode_32k",
                   "--mesh", mesh, "--device", "cpu", "--out", out]) == 0
    assert "[dryrun] 1 ok, 0 skip, 0 fail" in capsys.readouterr().out
    with open(out) as f:
        row, = json.load(f)
    n = make_production_mesh(multi_pod=mesh == "multi").size
    assert row["chips"] == n
    # batch 128 and the 16 (KV) heads divide the data and model axes of
    # both meshes: every dot is split n ways, none is repeated
    total = row["dot_flops_per_device"] * n
    assert abs(total - card_cost.dot_flops) <= 0.01 * card_cost.dot_flops, \
        (total, card_cost.dot_flops)
    # all flops but eager's layout copies: replication only adds (the
    # rope angles, masks and cache-length ops every rank repeats: 0.9 %
    # on single, 1.8 % on multi).  The card mesh's einsum copies each
    # layer's f32 K and V cache into bmm's (B * H, D, S) layout (20 % of
    # its flops); a shard with one KV head folds it without a copy.
    net = (row["hlo_flops_raw"] - row["copy_flops_per_device"]) * n
    card_net = card_cost.flops - card_cost.copy_flops
    assert card_net <= net <= 1.03 * card_net, (net, card_net)
    assert card_cost.copy_flops > 0.15 * card_cost.flops
    assert row["coll_bytes_per_device"] > 0
    assert sum(row["coll_by_axis"].values()) > 0
    assert set(row["axis_links"]) == set(
        make_production_mesh(multi_pod=mesh == "multi").axis_names)
    assert row["raw_cost_analysis"]["flops"] is None
    assert row["memory"]["resident_bytes"] > 0


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        D.lower_cell(TC.get("qwen1_5_0_5b"), "decode_32k", D.card_mesh(),
                     "card")
