#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. build   -- nvcc builds the four kernel sources from
              src/repro_torch/csrc into build/repro_torch (parallel, one
              nvcc per source; semilagrange.cu holds K3 and K4)
2. kernels -- each of the five kernels against its plain PyTorch version
              on the card, bitwise, on inputs that force its edge
              cases: K1 (both components in one launch, with and without
              the quantized fields) at blocks 16 and 13, on rounding
              half-way points, |dfp| beyond 2^32 up to the int64 edge
              and g >= 2^32 (its 64-bit path), frame runs that do not
              divide T; K5 (one persistent launch) on all-zero, all-255
              and only-symbols->=4 rows, ragged and unaligned rows; K3
              (sl_decode, one cooperative launch a field) on every
              blockmap pattern, partial blocks and clamped
              substeps; K4 with displacements that leave its halo, also
              against one launch of the per-frame stepper sl_step a frame;
              K2 verify_faces (one launch a verify round: screen or
              touched-face selection, predicate, compare, force) in both
              modes on the SCF analogue's first verify round, with a
              random delta, on all-zero / one-sign originals and on
              planes wider than a CTA's column block, and
              the subset predicate face_crossed on random faces; the
              unit-batched entries of the tiled path (lorenzo_residual_
              units, verify_faces_units, sl_decode_units) on chunks of
              1, 3 and 8 units of interior and edge signatures, blocks
              16 and 13, K2 in screen and delta modes, K3 with per-unit
              SL flags
3. parity  -- compress on the card == compress on the CPU, byte for byte,
              with the host codec and with codec="device", on a
              vortex-street field and on a field whose verify rounds
              fire, with an adaptive TilePolicy (version 3 header with
              the policy) and on a field holding NaN, +Inf and -Inf
              (given back bitwise); card blobs decode equal on both
              devices; the same for tiled containers (version 4, 5 and
              6, batch_units off, and the field whose verify rounds fire)
              and for compress_stream (serial and async, versions 4, 5
              and 6), and a salvage of a card container cut mid-frame
              == the CPU's; a tuned plan (monolithic and tiled), a
              stream with autotune=True, the target-ratio search (the
              uniform run sufficient, and the relax ladder) and the
              sz3-like / cpsz-like baselines on the card == on the CPU
4. main    -- compress -> decompress at full size with each codec: the
              SCF analogue vortex_street(T=120, H=100, W=225) and an
              archive field vortex_street(T=64, H=512, W=512), with the
              launches of every kernel counted over each run (counts set
              to 0 just before, read just after: one sl_decode a
              decompress, verify rounds + 1 a compress, the same for K1,
              K4 and verify_faces, no per-frame sl_step, no face_crossed,
              no dual_quantize outside K1), the pointwise bound,
              FC_t = FC_s = 0, the host codec's bytes and the device
              codec's decode == the host codec's decode checked, plus a
              traced run with host-clock seconds per stage and a
              torch.profiler run with the device's busy share; then the
              same with an adaptive policy (mode="rel", the protected
              wake at eb and the rest at 4 eb) at the SCF analogue with
              each codec and at 64x512x512 with codec="device": every
              vertex within its own bound, ratio and peak memory beside
              the uniform run's, the bound / cap tensors' MiB; and one
              compress a codec at the SCF analogue with repro_torch.obs
              tracing on (the untraced bytes, the stage spans, run_report
              summing to the container)
4d. tiled  -- the same two fields through compress_tiled with
              TileGrid(128, 128, 32), each codec, and the adaptive policy
              at the SCF analogue with codec="device": tiled decode ==
              monolithic decode bitwise, the bound, FC = 0, each kernel
              launched once per signature chunk of a verify round or of
              the final encode (not once per unit), ratio, seconds and
              peak memory beside the monolithic run's, and a one-unit
              decompress_region that reads one unit
4e. stream -- vortex_street(64, 512, 512) frame by frame from a generator
              through compress_stream with TileGrid(128, 128, 32), each
              codec, serial and async engine: the tiled phase's bytes,
              launches == the chunk counts, every kernel called on the
              caller's thread (threading.get_ident() of each call), the
              frames resident after every frame within the scheduler's
              bound, seconds, the async / serial ratio and the device
              busy share under torch.profiler; then an async
              device-codec stream of T = 128 (resident frames at the
              bound, peak device memory within 5 % of the 64-frame run)
4f. recovery -- at the SCF analogue a fresh interpreter SIGKILLs itself
              before a mid-stream frame and before the last frame, on
              each engine, once a checkpoint is durable (the async
              writer commits it after the ingest has read ahead);
              resume=True splices and finishes the uninterrupted bytes;
              the 64x512x512 stream container cut before its footer
              salvages every unit, and a copy with one unit's byte
              flipped decodes degraded: exactly that unit missing, its
              box holes, the rest == the clean decode
4g. query  -- the 64x512x512 tiled container's track index:
              track_summaries == the tracks of extraction.extract over
              the full decode; the longest track's read plan,
              decode_for_track's polyline == the extraction's bitwise, a
              warm query reading less than a cold one, seconds, units
              read and the launches of the cold query
4h. autotune -- a calibration on the card at the default shapes (into
              a temporary table under build/): the fitted (c0, c1) of
              the ten stages; tune_config with measure-verify at the
              SCF analogue and at 64x512x512: predicted and measured
              seconds of the three measured candidates, the chosen
              plan's bytes == the same plan set by hand, the pointwise
              bound and FC = 0, the launches, its seconds against the
              default monolithic plan's; tune_stream and a 64-frame
              compress_stream(autotune=True) == compress_tiled of the
              chosen plan; target_ratio at 1.5x the SCF uniform ratio
              (every vertex within its own policy bound, FC = 0, the
              rungs, the ratio reached); each baseline of
              repro_torch.baselines at the SCF analogue: ratio,
              seconds, FC_t / FC_s and launches
4i. serve -- the LM scaffold's serving path (repro_torch.launch.serve;
              no kernel of this package lies on it): for each of the ten
              registered architectures at SMOKE size, f32 and bf16
              activations, plus qwen1.5-32b's SMOKE with an int8 cache
              padded to 8 KV heads, the same parameters (seeded generator
              on the CPU, copied to the card) give prefill logits, four
              decode steps on a padded cache and the final cache on the
              card equal to the CPU's (f32: rtol = atol = 2e-4; bf16:
              max error <= 0.05 * max(1, max |CPU|); int8 entries within
              one step), with TF32 matmuls off; then yi-6b at full
              published width (random init on the card, 32 layers,
              d = 4096, 6.06 B parameters) served with the launcher's
              defaults: prefills, tokens, seconds, prefill seconds,
              decode tokens/s beside the weight-read bound, peak device
              memory, the device's busy share over one decode step, no
              compression kernel launched, and the last decode step's
              logits of one request against one prefill over its whole
              token sequence (bf16 bound as above)
4j. train -- the LM scaffold's training path (repro_torch.launch.train;
              no kernel of this package lies on it): for each of the ten
              architectures at SMOKE size with f32 activations, and one
              bf16 run a family, the same seeded parameters on the card
              and the CPU take two make_train_step steps on the token
              pipeline's batches: losses, every gradient leaf of the
              first step, parameters, m and v after the second, card ==
              CPU (f32: 2e-4 + 2e-4 |x|, parameters + 2 x the summed lr;
              bf16: 0.05 * max(1, max |CPU|)), TF32 off; microbatches=2
              against 1 on the card; compress_grads card == CPU bitwise
              over three rounds of error feedback; a checkpoint saved
              from the card restored on the CPU bitwise; then
              stablelm-1.6b at full published width (24 layers,
              d = 2048, 1.64 B parameters, random init on the card)
              trained through the launcher's defaults (batch 8 x seq
              128, f32 parameters and moments, no checkpoint) for six
              steps: losses (the first near ln V), step seconds and
              tokens/s beside the step's bound, peak device memory, one
              step under torch.profiler (device ms, ops, busy share; then
              its loss + backward and its AdamW apart, each beside its
              half of the bound) and no compression kernel launched
4k. dryrun -- the dry run (repro_torch.launch.dryrun; no kernel of this
              package lies on it): cells of the card mesh traced on fake
              CUDA tensors (flops, bytes, resident memory, bottleneck a
              cell; none fails), then stablelm-1.6b's train step at the
              train launcher's batch 8 x seq 128 and a yi-6b decode step
              at the serve launcher's 4 slots and max-len 128, each
              traced on fake tensors and run on the card under CostMode:
              equal flops, bytes and ops, the predicted peak within 10 %
              of torch.cuda.max_memory_allocated above the held, the
              roofline time beside the step's wall and profiled device
              time, stablelm's dot flops beside the 11.79 TFLOP hand count
4l. shard -- sharded execution of the LM scaffold (DTensor over a
              torch.distributed device mesh; no kernel of this package
              lies on it), in child processes (a process group is
              process-global): (a) with one card, an NCCL world of one
              runs two train steps of each of the ten SMOKE
              architectures (f32) with every parameter a DTensor on a
              (1, 1) mesh, held against the same card's steps without
              DTensor (the f32 bound of phase 4j; grad_norm within
              1e-5 relative); with two or more
              cards, min(count, 8) NCCL ranks run stablelm and yi SMOKE
              on an (n / 2, 2) mesh, held against one card; (b) the dry
              run's production meshes on a fake process group with fake
              CUDA tensors ("cuda" mesh): qwen1.5-0.5b decode_32k on
              single (16, 16) and multi (2, 16, 16), stablelm-1.6b
              train_4k on single: per-device flops, eager and workload
              bytes, collective bytes by kind and by axis, resident MiB,
              roofline terms, bottleneck, trace seconds, and the decode
              cell's dot flops times the mesh size within 1 % of the card
              mesh's, and its flops less eager's layout copies between
              1 and 1.03 times the card mesh's (the card mesh alone
              copies each layer's f32 K / V cache for bmm)
5. table   -- each kernel on the inputs its path gave it (the monolithic
              kernels: device codec, SCF analogue; the unit-batched
              entries and face_crossed: the tiled 64x512x512 device-codec
              run): equality with its plain version, time, plain time,
              bound and, where one PyTorch call computes the same
              function, that call's time

The last lines are a {"kernels": [...]} JSON line, the card's name and
power limit, and {"ok": true, "device": {...}}.  Imports nothing of JAX
or of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, the f64 rate
# outside the tensor cores (the stepper's scalar f64 cannot use them) and
# the dense bf16 tensor-core rate (the LM's matmuls)
HBM_BYTES_PER_S = 3.35e12
F64_FLOPS = 34e12
BF16_FLOPS = 989e12

SIZES = {
    "k1": (8, 256, 256),
    "k2": 1 << 20,
    # verify_faces on planes wider than a CTA's column block
    "k2_wide": [(3, 2, 1025), (10, 4, 20000)],
    "k3": (128, 192),
    "k4": (12, 128, 192),
    # sl_decode: (shape, block, blockmap kind, amplitude); the edge cases
    # of tests/test_torch_sl_decode.py plus the main sizes
    "k3_decode": [((6, 37, 53), b, k, a) for b in (16, 8)
                  for k in ("none", "all", "random", "first", "last", "runs")
                  for a in ("rk2", "clamped")]
    + [((120, 100, 225), 16, "random", "rk2"),
       ((16, 512, 512), 40, "runs", "clamped")],
    # (rows, row length, byte offset of the first row)
    "k5": [(1, 1, 0), (2, 1000, 0), (5, 4097, 3), (8, 1 << 20, 0),
           (2, 1 << 24, 0), (8, 1 << 24, 5), (8, (1 << 24) + 5, 0)],
    "parity": (8, 128, 192),
    "main": [(120, 100, 225), (64, 512, 512)],
    # adaptive-policy runs: (shape, codecs)
    "adaptive": [((120, 100, 225), ("host", "device")),
                 ((64, 512, 512), ("device",))],
    # unit-batched kernels: (extension, owned box (ot, oi, oj, To, Ho, Wo))
    # of a TileGrid(128, 128, 32) unit inside a later window / the first
    "units": {"interior": ((33, 130, 130), (1, 1, 1, 32, 128, 128)),
              "edge": ((33, 129, 130), (0, 0, 1, 32, 128, 128))},
    "unit_chunks": (1, 3, 8),
    # tiled parity on the card and the CPU: (shape, grid)
    "parity_tiled": ((8, 128, 192), (32, 48, 3)),
    # tiled runs at full width: (shape, codecs), TileGrid(128, 128, 32)
    "tiled": [((120, 100, 225), ("host", "device")),
              ((64, 512, 512), ("host", "device"))],
    "tile_grid": (128, 128, 32),
    # streamed runs (the tiled phase's archive field) and the longer
    # stream's length (four windows: the steady state's 97 resident
    # frames); the recovery children's kill points (frames) at the SCF
    # analogue: mid-stream and before the last frame
    "stream": (64, 512, 512),
    "stream_long": 128,
    "kill_at": (100, 119),
    # autotune / rate / baseline parity on the card and the CPU
    "parity_autotune": (6, 32, 32),
    # the rate search's target at full width, in units of the uniform ratio
    "rate_factor": 1.5,
    # LM serving: card == CPU at SMOKE (batch, prompt length, decode
    # steps), and the architecture served at full published width
    "serve_parity": (2, 32, 4),
    "serve_arch": "yi_6b",
    # LM training: card == CPU at SMOKE (batch, sequence, steps), and the
    # architecture trained at full published width for this many steps
    # (the launcher's batch 8 x seq 128)
    "train_parity": (2, 32, 2),
    "train_arch": "stablelm_1_6b",
    "train_steps": 6,
    # the dry run's cells on the card mesh (the full table: the CLI), and
    # the two steps held against the card: the train launcher's batch
    # (arch, batch, seq) and the serve launcher's slots and max-len
    "dryrun_cells": [("qwen1_5_0_5b", "decode_32k"), ("yi_6b", "decode_32k"),
                     ("qwen1_5_32b", "decode_32k"),
                     ("olmoe_1b_7b", "decode_32k"),
                     ("whisper_small", "decode_32k"),
                     ("qwen2_vl_7b", "decode_32k"),
                     ("jamba_1_5_large", "long_500k"),
                     ("rwkv6_3b", "long_500k"), ("yi_6b", "long_500k")],
    "dryrun_train": ("stablelm_1_6b", 8, 128),
    "dryrun_decode": ("yi_6b", 4, 128),
    # sharded steps: SMOKE batch (B, S) and steps; the architectures of
    # the multi-card run; the sharded dry-run cells (arch, shape, mesh)
    "shard_steps": (8, 32, 2),
    "shard_multi_archs": ("stablelm_1_6b", "yi_6b"),
    "shard_cells": [("qwen1_5_0_5b", "decode_32k", "single"),
                    ("qwen1_5_0_5b", "decode_32k", "multi"),
                    ("stablelm_1_6b", "train_4k", "single")],
}
# one sharded child process (its start-up, trace or steps)
SHARD_CHILD_TIMEOUT_S = 300

# the dry run's predicted peak against the card's (the readings so far
# are 0.02 % apart at most), and the hand count of stablelm-1.6b's train
# step (PERF.md section 5: 8 flops a matmul weight and token) with the
# band its dot flops must fall in: the block recompute (non-reentrant
# checkpointing) stops before each block's last matmul, w_down, whose
# forward is not run again, so the dots come to about 0.96 of the count
DRYRUN_PEAK_REL = 0.01
STABLELM_STEP_TFLOP = 11.79
STABLELM_DOT_BAND = (0.95, 1.0)

# card vs CPU (and decode vs prefill) bounds of the LM phase: the tests'
# f32 bound and bf16 bound (tests/test_torch_lm_models*.py)
LM_F32_TOL = 2e-4
# the sharded step's grad_norm against one card's, relative (on eight CPU
# gloo ranks sound runs read at most 2.4e-7, faulty ones at least 3.7e-4:
# tests/test_torch_sharded.py)
SHARD_NORM_REL = 1e-5
LM_BF16_REL = 0.05

# the host codec's container bytes at the main sizes with zlib (the card's
# machine has no zstandard), as the port wrote them from the start
HOST_ZLIB_BYTES = {(120, 100, 225): 1246961, (64, 512, 512): 5020441}

KERNELS = [
    # name, module, wrapper attribute, source, replaced Pallas function
    ("lorenzo_residual", "lorenzo", "lorenzo_residual",
     "src/repro_torch/csrc/lorenzo.cu", "src/repro/kernels/lorenzo/kernel.py:68"),
    ("verify_faces", "cptest", "verify_faces",
     "src/repro_torch/csrc/cptest.cu", "src/repro/kernels/cptest/kernel.py:102"),
    ("sl_decode", "semilagrange", "sl_decode",
     "src/repro_torch/csrc/semilagrange.cu",
     "src/repro/kernels/semilagrange/kernel.py:106"),
    ("sl_step_batched", "semilagrange", "sl_step_batched",
     "src/repro_torch/csrc/semilagrange.cu",
     "src/repro/kernels/semilagrange/kernel.py:128"),
    ("symbol_histogram", "entropy", "symbol_histogram",
     "src/repro_torch/csrc/entropy.cu",
     "src/repro/kernels/entropy/kernel.py:46"),
    # the tiled path's unit-batched entries, and K2's face predicate (the
    # track index's crossed tet faces)
    ("lorenzo_residual_units", "lorenzo", "lorenzo_residual_units",
     "src/repro_torch/csrc/lorenzo.cu", "src/repro/kernels/lorenzo/kernel.py:68"),
    ("verify_faces_units", "cptest", "verify_faces_units",
     "src/repro_torch/csrc/cptest.cu", "src/repro/kernels/cptest/kernel.py:102"),
    ("sl_decode_units", "semilagrange", "sl_decode_units",
     "src/repro_torch/csrc/semilagrange.cu",
     "src/repro/kernels/semilagrange/kernel.py:106"),
    ("face_crossed", "cptest", "face_crossed",
     "src/repro_torch/csrc/cptest.cu", "src/repro/kernels/cptest/kernel.py:102"),
]
# kernels only the tiled path launches (the monolithic path must not)
TILED_ONLY = ("lorenzo_residual_units", "verify_faces_units",
              "sl_decode_units", "face_crossed")


def say(*parts):
    print(*parts, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def modules():
    from repro_torch.kernels.cptest import kernel as k2, ref as r2
    from repro_torch.kernels.entropy import kernel as k5, ref as r5
    from repro_torch.kernels.lorenzo import kernel as k1, ref as r1
    from repro_torch.kernels.semilagrange import kernel as k3, ref as r3
    return {"lorenzo": (k1, r1), "cptest": (k2, r2), "semilagrange": (k3, r3),
            "entropy": (k5, r5)}


def wrappers():
    """{name: the kernel wrapper function whose ``launches`` counts}, the
    kernels of KERNELS and the per-frame stepper sl_step, which no path
    launches."""
    mods = modules()
    fns = {name: getattr(mods[mod][0], attr)
           for name, mod, attr, _, _ in KERNELS}
    fns["sl_step"] = mods["semilagrange"][0].sl_step
    return fns


def time_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def same(a, b) -> bool:
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def max_abs_err(a, b) -> float:
    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max()) \
        if a.numel() else 0.0


# ----------------------------------------------------------------------
# phase 1: build
# ----------------------------------------------------------------------

def phase_build():
    from repro_torch import kernels
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    secs = kernels.build_all()
    total = time.perf_counter() - t0
    say(f"build: {total:.2f} s total, per source {json.dumps(secs)} "
        f"-> {_build.BUILD_DIR}")
    for name in kernels.KERNELS:
        log = _build.BUILD_DIR / f"{name}.log"
        for line in log.read_text().splitlines() if log.exists() else []:
            if "registers" in line or "spill" in line:
                say(f"  ptxas {name}: {line.strip()}")
    say("nvidia-smi:", smi_line())
    say("kernels:", ", ".join(f"{n} ({src})" for n, _, _, src, _ in KERNELS))


# ----------------------------------------------------------------------
# phase 2: kernel == plain version on random inputs
# ----------------------------------------------------------------------

def phase_kernels(dev):
    mods = modules()
    rng = np.random.default_rng(0)
    k1, r1 = mods["lorenzo"]
    T, H, W = SIZES["k1"]
    cases = [(xi, block, 2 ** 29, None) for xi in (1, 3, 1024, 2 ** 27)
             for block in (16, 13)]
    # the 64-bit path: |dfp| beyond 2^32 up to the int64 edge, g >= 2^32;
    # frame runs of 1 and 3 (not dividing T = 8) and a block of 40
    cases += [(3, 16, 2 ** 62, 3), (2 ** 31, 13, 2 ** 40, 1),
              (7, 40, 2 ** 33, None)]
    for xi_unit, block, amp, run in cases:
        ufp, vfp, k, ll = lorenzo_inputs((T, H, W), xi_unit, amp, rng, dev)
        if amp > 2 ** 32:
            ufp[0, 0, :4] = torch.tensor(
                [2 ** 63 - 1, -(2 ** 63) + 1, 2 ** 62, -(2 ** 63)], device=dev)
        want = r1.lorenzo_residual(ufp, vfp, k, ll, xi_unit, block, True)
        for want_x in (False, True):
            n0 = k1.lorenzo_residual.launches
            got = k1.lorenzo_residual(ufp, vfp, k, ll, xi_unit, block,
                                      want_x, run)
            torch.cuda.synchronize()
            assert k1.lorenzo_residual.launches == n0 + 1
            assert same(got, want[:len(got)]), \
                f"K1 differs xi={xi_unit} block={block} amp={amp} run={run}"
    say(f"K1 lorenzo_residual (u and v in one launch) == plain on "
        f"{(T, H, W)}, with and without X, (xi_unit, block, |dfp| <, run) "
        f"{cases}: bitwise")

    k2, r2 = mods["cptest"]
    n = SIZES["k2"]
    n_v = 3 * n
    u = rng.integers(-(2 ** 29), 2 ** 29, n_v)
    v = rng.integers(-(2 ** 29), 2 ** 29, n_v)
    zero = rng.random(n_v) < 0.2                 # a fifth of the values 0
    u[zero] = 0
    v[rng.random(n_v) < 0.2] = 0
    small = rng.random(n_v) < 0.3                # small values: det ties
    u[small] = rng.integers(-2, 3, int(small.sum()))
    v[small] = rng.integers(-2, 3, int(small.sum()))
    verts = rng.integers(0, n_v, (n, 3))
    tie = rng.random(n) < 0.25                   # collinear pairs: det == 0
    u[verts[tie, 1]] = 2 * u[verts[tie, 0]]
    v[verts[tie, 1]] = 2 * v[verts[tie, 0]]
    args = [torch.as_tensor(a, device=dev) for a in (u, v, verts)]
    got = k2.face_crossed(*args)
    want = r2.face_crossed(*args)
    assert same(got, want), "K2 differs"
    say(f"K2 face_crossed == plain on {n} faces (zeros, ties, collinear "
        f"pairs; {int(want.sum())} crossed): bitwise")
    verify_faces_cases(dev, k2, r2)

    k3, r3 = mods["semilagrange"]
    for shape, block, kind, amp in SIZES["k3_decode"]:
        a, cfl, n_max = DECODE_AMPS[amp]
        args = decode_inputs(kind, shape, block, a, dev) + (
            block, 0.01, cfl, 0.7 * cfl, 2.0, n_max)
        got = k3.sl_decode(*args)
        assert same(got, r3.sl_decode(*args)), \
            f"K3 sl_decode differs: {shape} block {block} {kind} {amp}"
    say(f"K3 sl_decode == plain on {len(SIZES['k3_decode'])} cases: "
        "(6, 37, 53) x block 16/8 x blockmap none/all/random/first/last/"
        "runs x RK2-only/clamped substeps, (120, 100, 225) block 16 random, "
        f"(16, 512, 512) block 40 runs (grid {k3.sl_decode.grid} CTAs, "
        "units beyond the registers): bitwise")

    H, W = SIZES["k3"]
    for amp, cfl in ((50, 0.05), (5e4, 0.01), (5e4, 0.2)):
        xu = torch.as_tensor(rng.integers(-amp, amp + 1, (H, W)), device=dev)
        xv = torch.as_tensor(rng.integers(-amp, amp + 1, (H, W)), device=dev)
        g2f = 0.01
        disp = float(max(xu.abs().max(), xv.abs().max())) * g2f * cfl
        got = k3.sl_step(xu, xv, g2f, cfl, cfl, 2.0, 32)
        want = r3.sl_step(xu, xv, g2f, cfl, cfl, 2.0, 32)
        assert same(got, want), f"sl_step differs at max displacement {disp}"
        say(f"per-frame sl_step == plain on {(H, W)}, max displacement "
            f"{disp:.1f} cells (d_max*n_max = 64): bitwise")

    B, H, W = SIZES["k4"]
    # 3e3 at cfl 0.1: departures of up to 3 cells beside RK2 pixels, at
    # the edge of K4's 4-cell halo; 5e4: substeps far beyond it
    for amp, cfl in ((50, 0.05), (3e3, 0.1), (5e4, 0.01), (5e4, 0.2)):
        xu = torch.as_tensor(rng.integers(-amp, amp + 1, (B, H, W)), device=dev)
        xv = torch.as_tensor(rng.integers(-amp, amp + 1, (B, H, W)), device=dev)
        xu[1::3] //= 100                         # frames with fewer substeps
        args = (0.01, cfl, cfl, 2.0, 32)
        got = k3.sl_step_batched(xu, xv, *args)
        assert same(got, r3.sl_step_batched(xu, xv, *args)), "K4 != plain"
        for b in range(B):
            one = k3.sl_step(xu[b], xv[b], *args)
            assert same((got[0][b], got[1][b]), one), \
                f"K4 != sl_step frame {b}"
        say(f"K4 sl_step_batched == plain and == {B} sl_step launches on "
            f"{(B, H, W)}, amplitude {amp:g}, cfl {cfl}: bitwise")

    k5, r5 = mods["entropy"]
    for B, n, offset in SIZES["k5"]:
        flat = torch.randint(0, 256, (offset + B * n,), dtype=torch.uint8,
                             device=dev)
        flat[offset::2] = torch.randint(0, 4, flat[offset::2].shape,
                                        dtype=torch.uint8, device=dev)
        sym = flat[offset:].view(B, n)
        if B >= 3:
            sym[1] = 0
            sym[2] = 255
        if B >= 4:
            sym[3] = torch.randint(4, 256, (n,), dtype=torch.uint8,
                                   device=dev)
        got = k5.symbol_histogram(sym)
        assert same(got, r5.symbol_histogram(sym)), f"K5 differs {(B, n)}"
        assert int(got.sum()) == B * n
    say(f"K5 symbol_histogram == plain on (rows, n, offset) {SIZES['k5']} "
        "(random, small-symbol, all-0, all-255 and only->=4 rows; the "
        "workspace reused across them): bitwise")
    unit_kernel_cases(dev, mods, rng)


def unit_kernel_cases(dev, mods, rng):
    """The unit-batched entries against their plain versions, bitwise, on
    chunks of 1, 3 and 8 units of the tiled path's interior and edge
    signatures: K1 at blocks 16 and 13, K2 screen and delta, K3 with SL
    flags that differ between units."""
    k1, r1 = mods["lorenzo"]
    k2, r2 = mods["cptest"]
    k3, r3 = mods["semilagrange"]
    for kind, (ext, owned) in SIZES["units"].items():
        for B in SIZES["unit_chunks"]:
            for block in (16, 13):
                ufp, vfp, k, ll = lorenzo_inputs((B,) + ext, 5, 2 ** 29, rng,
                                                 dev)
                n0 = k1.lorenzo_residual_units.launches
                got = k1.lorenzo_residual_units(ufp, vfp, k, ll, 5, block,
                                                owned)
                torch.cuda.synchronize()
                assert k1.lorenzo_residual_units.launches == n0 + 1
                want = r1.lorenzo_residual_units(ufp, vfp, k, ll, 5, block,
                                                 owned)
                assert same(got, want), \
                    f"K1 units differ: {kind} B={B} block={block}"
            shape = (9,) + ext[1:]
            fields = [wide_fields(shape, dev, seed=b) for b in range(B)]
            ufp, vfp, ur, vr = (torch.stack([f[i] for f in fields])
                                for i in range(4))
            preds = [all_predicates(r2, ufp[b], vfp[b]) for b in range(B)]
            st, sb = preds[0][:2]
            s0 = torch.stack([p[2] for p in preds])
            b0 = torch.stack([p[3] for p in preds])
            g = torch.Generator(device=dev).manual_seed(B)
            pre = torch.rand(ur.shape, generator=g, device=dev) < 0.05
            counts = []
            for d in (None, torch.rand(ur.shape, generator=g, device=dev)
                      < 0.05):
                got_f, want_f = pre.clone(), pre.clone()
                n0 = k2.verify_faces_units.launches
                got = k2.verify_faces_units(ur, vr, ufp, vfp, d, st, sb, s0,
                                            b0, got_f)
                torch.cuda.synchronize()
                assert k2.verify_faces_units.launches == n0 + 1
                want = r2.verify_faces_units(ur, vr, ufp, vfp, d, st, sb, s0,
                                             b0, want_f)
                assert int(got) == int(want) > 0 and same(got_f, want_f), \
                    f"K2 units differ: {kind} B={B} delta={d is not None}"
                counts.append(int(got))
            To, Ho, Wo = owned[3:]
            kinds = ("random", "none", "first", "runs", "all", "last")
            parts = [decode_inputs(kinds[b % len(kinds)], (To, Ho, Wo), 16,
                                   20 + b, dev) for b in range(B)]
            args = tuple(torch.stack([p[i] for p in parts]) for i in range(6))
            args += (16, 0.01, 0.05, 0.035, 2.0, 8)
            n0 = k3.sl_decode_units.launches
            got = k3.sl_decode_units(*args)
            torch.cuda.synchronize()
            assert k3.sl_decode_units.launches == n0 + 1
            assert same(got, r3.sl_decode_units(*args)), \
                f"K3 units differ: {kind} B={B}"
            say(f"unit kernels {kind} B={B}: K1 lorenzo_residual_units "
                f"(extension {ext}, owned {owned}, blocks 16 and 13), K2 "
                f"verify_faces_units on {(B,) + shape} (screen / delta "
                f"{counts} bad faces), K3 sl_decode_units on {(B, To, Ho, Wo)}"
                f" ({k3.sl_decode_units.grid} CTAs, blockmaps "
                f"{[kinds[b % len(kinds)] for b in range(B)]}) == plain: "
                "bitwise")


def verify_faces_check(k2, r2, args):
    """verify_faces == plain on ``args`` (count and forced, each from its
    own copy of forced), one launch; returns the count."""
    *rest, forced = args
    got_f, want_f = forced.clone(), forced.clone()
    n0 = k2.verify_faces.launches
    got = k2.verify_faces(*rest, got_f)
    torch.cuda.synchronize()
    assert k2.verify_faces.launches == n0 + 1
    want = r2.verify_faces(*rest, want_f)
    assert int(got) == int(want) and same(got_f, want_f), \
        "verify_faces differs"
    assert same(got_f | forced, got_f), "verify_faces cleared a forced bit"
    return int(got)


def first_verify_round(dev):
    """The verify_faces arguments of the SCF analogue's first verify
    round on the card (a compress with backend.verify_faces wrapped)."""
    import repro_torch as rt
    from repro_torch.core import backend
    from repro_torch.data import synthetic

    T, H, W = SIZES["main"][0]
    u, v = synthetic.vortex_street(T=T, H=H, W=W)
    seen = []
    orig = backend.verify_faces

    def keep(*args):
        if not seen:
            seen.append(tuple(a.clone() if torch.is_tensor(a) else a
                              for a in args))
        return orig(*args)
    backend.verify_faces = keep
    try:
        rt.compress(u, v, rt.CompressionConfig(codec="device",
                                               **scf_meta(T, H, W)),
                    device=dev)
    finally:
        backend.verify_faces = orig
    return seen[0]


def verify_faces_cases(dev, k2, r2):
    """K2 verify_faces in both modes on the SCF analogue's first verify
    round (screen; a random 1 % delta and a full delta, also with u
    shifted so that predicates flip), on all-zero and one-sign
    originals (every / no face selected), and on planes wider than a
    CTA's column block."""
    ur, vr, ufp, vfp, _, st, sb, s0, b0, forced = first_verify_round(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    n_screen = verify_faces_check(
        k2, r2, (ur, vr, ufp, vfp, None, st, sb, s0, b0, forced))
    # u shifted by 2^20 moves the zero set, so some predicates flip
    shifted = ur + (1 << 20)
    counts = []
    for frac in (0.01, 1.0):
        delta = torch.rand(ur.shape, generator=g, device=dev) < frac
        pre = torch.rand(ur.shape, generator=g, device=dev) < 0.05
        for urx in (ur, shifted):
            counts.append(verify_faces_check(
                k2, r2, (urx, vr, ufp, vfp, delta, st, sb, s0, b0, pre)))
    # all-zero originals: the screen clears no face
    zero = torch.zeros_like(ufp)
    n_zero = verify_faces_check(
        k2, r2, (shifted, vr, zero, zero, None, st, sb, s0, b0, forced))
    pos = torch.full_like(ufp, 7)
    n_pos = verify_faces_check(
        k2, r2, (pos + 1, pos + 2, pos, pos, None, st, sb, s0, b0, forced))
    assert n_zero > 0 and n_pos == 0
    n_wide = []
    for shape in SIZES["k2_wide"]:
        ufp_w, vfp_w, ur_w, vr_w = wide_fields(shape, dev)
        st_w, sb_w, s0_w, b0_w = all_predicates(r2, ufp_w, vfp_w)
        pre = torch.rand(shape, generator=g, device=dev) < 0.05
        for d in (None, torch.rand(shape, generator=g, device=dev) < 0.05):
            n_wide.append(verify_faces_check(
                k2, r2, (ur_w, vr_w, ufp_w, vfp_w, d, st_w, sb_w, s0_w,
                         b0_w, pre)))
    assert min(n_wide) > 0
    say(f"K2 verify_faces == plain (count and forced) on the SCF analogue's "
        f"first verify round {tuple(ur.shape)}: screen {n_screen} bad faces, "
        f"random 1 % / full delta {counts[0]} / {counts[2]} (u shifted by "
        f"2^20: {counts[1]} / {counts[3]}), all-zero "
        f"original with u shifted {n_zero}, one-sign fields {n_pos}; planes "
        f"wider than a CTA's column block {SIZES['k2_wide']} (screen / "
        f"random delta {n_wide}): bitwise")


def wide_fields(shape, dev, seed=0):
    """(ufp, vfp, ur_fp, vr_fp) on the card: values near zero with sign
    ties, a fifth of them large, reconstructions moved by -2..2."""
    g = torch.Generator(device=dev).manual_seed(sum(shape) + seed)
    o = torch.randint(-3, 4, (2,) + shape, generator=g, device=dev)
    big = torch.rand(o.shape, generator=g, device=dev) < 0.2
    o = torch.where(big, torch.randint(-(1 << 20), 1 << 20, o.shape,
                                       generator=g, device=dev), o)
    r = o + torch.randint(-2, 3, o.shape, generator=g, device=dev)
    return o[0].contiguous(), o[1].contiguous(), r[0].contiguous(), \
        r[1].contiguous()


def all_predicates(r2, ufp, vfp):
    """(slice_tab, slab_tab, slice0, slab0): the mesh's tables and the
    plain predicate of every face on (ufp, vfp)."""
    from repro_torch.core import grid

    T, H, W = ufp.shape
    tabs = grid.device_tables(H, W, str(ufp.device))
    t = torch.arange(T, device=ufp.device)[:, None, None] * (H * W)
    uf, vf = ufp.reshape(-1), vfp.reshape(-1)
    sl = (tabs["slice"][None] + t).reshape(-1, 3)
    sb = (tabs["slab"][None] + t[:-1]).reshape(-1, 3)
    return (tabs["slice"], tabs["slab"],
            r2.face_crossed(uf, vf, sl).reshape(T, -1),
            r2.face_crossed(uf, vf, sb).reshape(T - 1, -1))


def lorenzo_inputs(shape, xi_unit, amp, rng, dev):
    """(ufp, vfp, k, lossless) for K1: n_levels 3 with lossless vertices,
    |dfp| < amp, a quarter of the values on a rounding half-way point."""
    from repro_torch.core import quantize

    eb = torch.as_tensor(rng.integers(0, 8 * xi_unit, shape), device=dev)
    k, ll = quantize.quantize_eb(eb, xi_unit, 3)
    kk = torch.where(ll, 0, k.clamp(min=0)).to(torch.int64)
    half = torch.full_like(kk, xi_unit) << kk
    comps = []
    for _ in range(2):
        d = torch.as_tensor(rng.integers(-amp, amp, shape), device=dev)
        m = torch.as_tensor(rng.integers(0, 1000, shape), device=dev)
        on = torch.as_tensor(rng.random(shape) < 0.25, device=dev)
        comps.append(torch.where(on, (2 * m + 1) * half, d))
    return (*comps, k, ll)


# (residual amplitude, cfl, n_max): RK2 only / substeps clamped at n_max
DECODE_AMPS = {"rk2": (20, 0.05, 8), "clamped": (400, 0.5, 4)}


def decode_inputs(kind, shape, block, amp, dev):
    """(c2u, c2v, res_u, res_v, blockmap, flags) for sl_decode: seeded
    residuals of amplitude ``amp`` and a blockmap of the named kind (none,
    all, random 30 %, SL only in frame 1, only in the last frame, runs of
    SL frames between runs without)."""
    from repro_torch.core import predictors

    rng = np.random.default_rng([block, amp, *shape])
    T, H, W = shape
    nb = (T, -(-H // block), -(-W // block))
    res = [torch.as_tensor(rng.integers(-amp, amp + 1, shape), device=dev)
           for _ in range(2)]
    some = rng.random(nb[1:]) < 0.5
    some.flat[0] = True
    bm = np.zeros(nb, dtype=bool)
    if kind == "all":
        bm[:] = True
    elif kind == "random":
        bm = rng.random(nb) < 0.3
    elif kind == "first":
        bm[1] = some
    elif kind == "last":
        bm[-1] = some
    elif kind == "runs":
        bm[1:T // 3] = some
        bm[T // 2:T // 2 + 2] = some
    flags = bm.reshape(T, -1).any(axis=1)
    flags[0] = False
    c2 = [predictors.c2_block(r, block).contiguous() for r in res]
    return (*c2, *res,
            torch.as_tensor(bm.astype(np.uint8), device=dev),
            torch.as_tensor(flags.astype(np.uint8), device=dev))


# ----------------------------------------------------------------------
# phase 3: card == CPU
# ----------------------------------------------------------------------

def scf_meta(T, H, W):
    # the SCF analogue's metadata (benchmarks/datasets.py)
    return dict(dt=0.05, dx=2.0 / (W - 1), dy=1.0 / (H - 1))


def large_magnitude_field():
    rng = np.random.default_rng(3)
    T, H, W = 4, 16, 16
    u = (1.0e8 + rng.normal(0, 100.0, (T, H, W))).astype(np.float32)
    v = (1.0e8 + rng.normal(0, 100.0, (T, H, W))).astype(np.float32)
    return u, v


def phase_parity(dev):
    import repro_torch as rt
    from repro_torch.data import synthetic

    T, H, W = SIZES["parity"]
    fields = [("vortex_street",) + synthetic.vortex_street(T=T, H=H, W=W)
              + (dict(eb=1e-3, **scf_meta(T, H, W)),),
              ("large_magnitude",) + large_magnitude_field()
              + (dict(eb=6.0, mode="abs"),)]
    cases = [(f"{name} codec={codec}", fu, fv,
              rt.CompressionConfig(codec=codec, **kw))
             for codec in ("host", "device") for name, fu, fv, kw in fields]
    for name, u, v, cfg in cases:
        b_dev, s_dev = rt.compress(u, v, cfg, device=dev)
        b_cpu, s_cpu = rt.compress(u, v, cfg, device="cpu")
        assert b_dev == b_cpu, f"{name}: card and CPU blobs differ"
        assert s_dev["verify_bad_counts"] == s_cpu["verify_bad_counts"]
        if name.startswith("large_magnitude"):
            assert s_dev["verify_rounds"] >= 1, "verify rounds did not fire"
        magics = (b"CPTH1",) if cfg.codec == "device" else (b"CPTZ1",
                                                            b"CPTL1")
        assert b_dev[:5] in magics, f"{name}: container magic {b_dev[:5]!r}"
        ur_d, vr_d = rt.decompress(b_dev, device=dev)
        ur_c, vr_c = rt.decompress(b_dev, device="cpu")
        assert np.array_equal(ur_d, ur_c) and np.array_equal(vr_d, vr_c)
        say(f"parity {name} {u.shape}: card blob == CPU blob "
            f"({len(b_dev)} B, verify rounds {s_dev['verify_rounds']}, "
            f"bad counts {s_dev['verify_bad_counts']}); decode equal")
    parity_adaptive(dev, fields[0][1], fields[0][2])
    parity_nonfinite(dev, fields[0][1], fields[0][2])
    parity_tiled(dev, fields[0][1], fields[0][2])
    parity_stream(dev, fields[0][1], fields[0][2])
    parity_autotune(dev)


def parity_tiled(dev, u, v):
    """Tiled containers on the card == on the CPU: version 4 (host
    codec), 5 (device codec), 6 (adaptive policy), batch_units off, and
    the field whose verify rounds fire; decode equal on both devices."""
    import repro_torch as rt
    from repro_torch.core import ebpolicy, encode

    (T, H, W), g = SIZES["parity_tiled"]
    pol = ebpolicy.TilePolicy.make(**PARITY_POLICY)
    meta = dict(eb=1e-3, **scf_meta(T, H, W))
    big_u, big_v = large_magnitude_field()
    cases = [("v4", u, v, dict(meta), g), ("v5", u, v,
                                           dict(meta, codec="device"), g),
             ("v6", u, v, dict(eb=5e-2, mode="abs", codec="device",
                                eb_policy=pol,
                                n_levels=ebpolicy.levels_for(pol)), g),
             ("v4 batch_units=False", u, v, dict(meta, batch_units=False), g),
             ("rounds firing", big_u, big_v, dict(eb=6.0, mode="abs"),
              (4, 4, 2))]
    for name, fu, fv, kw, grid in cases:
        cfg = rt.CompressionConfig(**kw)
        tg = rt.TileGrid(*grid)
        b_dev, s_dev = rt.compress_tiled(fu, fv, cfg, tg, device=dev)
        b_cpu, s_cpu = rt.compress_tiled(fu, fv, cfg, tg, device="cpu")
        tag = f"parity tiled {name} {fu.shape} {tg}"
        assert b_dev == b_cpu, f"{tag}: card and CPU blobs differ"
        assert s_dev["verify_bad_counts"] == s_cpu["verify_bad_counts"]
        assert s_dev["chunks"] == s_cpu["chunks"]
        if name == "rounds firing":
            assert s_dev["verify_rounds"] >= 1, "verify rounds did not fire"
        version = encode.tiled_header(b_dev)["version"]
        assert version == {"v5": 5, "v6": 6}.get(name[:2], 4), version
        d_dev = rt.decompress(b_dev, device=dev)
        d_cpu = rt.decompress(b_dev, device="cpu")
        assert all(np.array_equal(a, b) for a, b in zip(d_dev, d_cpu))
        say(f"{tag}: card blob == CPU blob ({len(b_dev)} B, version "
            f"{version}, {s_dev['n_units']} units, chunks "
            f"{json.dumps(s_dev['chunks'])}, verify rounds "
            f"{s_dev['verify_rounds']} {s_dev['verify_bad_counts']}); decode "
            "equal")


def parity_stream(dev, u, v):
    """compress_stream on the card == on the CPU, serial and async
    engine, for versions 4, 5 and 6; a salvage of the card container cut
    mid-frame == the CPU's, and decodes equal on both devices."""
    import repro_torch as rt
    from repro_torch.core import ebpolicy, encode

    (T, H, W), g = SIZES["parity_tiled"]
    pol = ebpolicy.TilePolicy.make(**PARITY_POLICY)
    meta = dict(eb=1e-3, **scf_meta(T, H, W))
    vr = value_range(u, v)
    tg = rt.TileGrid(*g)
    cases = [("v4", dict(meta)), ("v5", dict(meta, codec="device")),
             ("v6", dict(eb=5e-2, mode="abs", codec="device", eb_policy=pol,
                         n_levels=ebpolicy.levels_for(pol)))]
    for name, kw in cases:
        cfg = rt.CompressionConfig(**kw)
        b_cpu, _ = rt.compress_stream(frames(u, v), cfg, tg, value_range=vr,
                                      device="cpu")
        for engine in ("serial", "async"):
            b_dev, st = rt.compress_stream(frames(u, v), cfg, tg,
                                           value_range=vr, device=dev,
                                           async_engine=engine == "async")
            tag = f"parity stream {name} {engine} {u.shape} {tg}"
            assert b_dev == b_cpu, f"{tag}: card and CPU blobs differ"
            version = encode.tiled_header(b_dev)["version"]
            assert version == int(name[1]), version
            say(f"{tag}: card blob == CPU blob ({len(b_dev)} B, version "
                f"{version}, {st['n_units']} units)")
        units = sorted(encode.tiled_header(b_dev)["units"],
                       key=lambda e: e["off"])
        cut = units[len(units) // 2]["off"] + 7
        s_dev, rep_dev = encode.salvage_container(b_dev[:cut])
        s_cpu, rep_cpu = encode.salvage_container(b_cpu[:cut])
        assert s_dev == s_cpu and rep_dev == rep_cpu \
            and rep_dev["units_recovered"] == len(units) // 2
        d_dev = rt.decompress(s_dev, device=dev)
        d_cpu = rt.decompress(s_dev, device="cpu")
        assert all(np.array_equal(a, b) for a, b in zip(d_dev, d_cpu))
        say(f"parity salvage {name}: card container cut at byte {cut} "
            f"salvages to the CPU's bytes ({len(s_dev)} B, "
            f"{rep_dev['units_recovered']} of {len(units)} units); decode "
            "equal")


def fixed_table(kind, mono):
    """A fixed calibration table for ``kind``; ``mono`` scales the
    monolithic stages' coefficients (1000 makes a tiled plan win)."""
    from repro_torch import autotune
    from repro_torch.autotune import costmodel

    return autotune.CalibrationTable(device_kind=kind, coeffs={
        (kind, st): (1e-4 * (i + 1) * (mono if i < 5 else 1.0),
                     1e-8 * (i + 2) * (mono if i < 5 else 1.0))
        for i, st in enumerate(costmodel.STAGES)})


class TablePath:
    """Points the autotune's default calibration-table path at ``path``
    for a run (``compress_stream(autotune=True)`` loads its table from
    there), so nothing is read or written outside the checkout."""

    def __init__(self, path):
        self.path = str(path)

    def __enter__(self):
        import importlib

        self._mod = importlib.import_module("repro_torch.autotune.calibrate")
        self._orig = self._mod.default_table_path
        self._mod.default_table_path = lambda: self.path
        return self

    def __exit__(self, *exc):
        self._mod.default_table_path = self._orig


def parity_autotune(dev):
    """Autotuned, rate-targeted and baseline bytes on the card == on the
    CPU, on small fields: the plan a fixed table picks (monolithic, and
    tiled with the device codec), a stream with autotune=True, the
    target-ratio search with the uniform run sufficient and with the
    relax ladder, and sz3-like / cpsz-like sizes and reconstructions."""
    import tempfile

    import repro_torch as rt
    from repro_torch import autotune, baselines
    from repro_torch.data import synthetic

    T, H, W = SIZES["parity_autotune"]
    rng = np.random.default_rng(3)
    u = np.cumsum(rng.normal(size=(T, H, W)).astype(np.float32), axis=0)
    v = u[::-1].copy()
    devices = (dev, torch.device("cpu"))
    for mono in (1.0, 1000.0):
        cfg = rt.CompressionConfig(eb=1e-2)
        plans, blobs = [], []
        for d in devices:
            tuned = autotune.tune_config(
                u, v, cfg, table=fixed_table(autotune.device_kind(d), mono),
                measure=False, device=d)
            plans.append(autotune.last_report()["chosen"])
            blobs.append(rt.compress(u, v, tuned, device=d)[0])
        assert plans[0] == plans[1] and blobs[0] == blobs[1], \
            f"parity autotune {plans}: card and CPU blobs differ"
        say(f"parity autotune {(T, H, W)} (monolithic stages x{mono}): "
            f"plan {plans[0]}, card blob == CPU blob ({len(blobs[0])} B)")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        blobs = []
        for i, d in enumerate(devices):
            path = Path(tmp) / f"{i}.json"
            autotune.save_table(fixed_table(autotune.device_kind(d), 1.0),
                                str(path))
            with TablePath(path):
                b, st = rt.compress_stream(frames(u, v),
                                           rt.CompressionConfig(eb=1e-2),
                                           autotune=True, n_frames_hint=T,
                                           device=d)
            blobs.append(b)
        assert blobs[0] == blobs[1], "parity stream autotune: blobs differ"
        say(f"parity stream autotune {(T, H, W)}: plan "
            f"{autotune.last_report()['chosen']}, card blob == CPU blob "
            f"({len(blobs[0])} B, async {st['async_engine']})")
    gu, gv = synthetic.double_gyre(T=T, H=H, W=H)
    cfg = rt.CompressionConfig(eb=1e-3, mode="abs")
    uniform = rt.compress(gu, gv, cfg, device="cpu")[1]["ratio"]
    for factor in (0.5, 1.5):
        b_dev, s_dev = rt.compress(gu, gv, cfg, device=dev,
                                   target_ratio=uniform * factor)
        b_cpu, s_cpu = rt.compress(gu, gv, cfg, device="cpu",
                                   target_ratio=uniform * factor)
        rec = s_dev["rate_target"]
        assert b_dev == b_cpu and rec == s_cpu["rate_target"], \
            f"parity rate x{factor}: card and CPU differ"
        say(f"parity rate {gu.shape} target {uniform * factor:.4f} "
            f"(x{factor} uniform): card blob == CPU blob ({len(b_dev)} B), "
            f"record equal (rungs {rec.get('rungs_tried')}, met "
            f"{rec['met']})")
    for name in ("sz3-like", "cpsz-like"):
        a = baselines.REGISTRY[name](u, v, eb=1e-2, device=dev)
        b = baselines.REGISTRY[name](u, v, eb=1e-2, device="cpu")
        assert a["comp_bytes"] == b["comp_bytes"] and all(
            np.array_equal(a[k].view(np.uint32), b[k].view(np.uint32))
            for k in ("u_rec", "v_rec")), f"parity {name}: card != CPU"
        say(f"parity {name} {u.shape}: card size == CPU size "
            f"({a['comp_bytes']} B), reconstructions bitwise equal")


def frames(u, v):
    """The field as a generator of (u_t, v_t) frames."""
    return ((u[t], v[t]) for t in range(u.shape[0]))


def value_range(u, v):
    return (float(min(u.min(), v.min())), float(max(u.max(), v.max())))


# the adaptive policy of the reference's tests (tests/test_ebpolicy.py)
PARITY_POLICY = dict(window_t=2, tile_h=6, tile_w=8, default=5e-2,
                     values={(0, 0, 0): 5e-3, (1, 1, 1): 1e-2,
                             (2, 2, 1): 2e-3})


def parity_adaptive(dev, u, v):
    """An adaptive (TilePolicy, version 3) compress on the card == on
    the CPU, with both codecs; the header carries the policy; decode
    equal on both devices."""
    import repro_torch as rt
    from repro_torch.core import ebpolicy, encode

    pol = ebpolicy.TilePolicy.make(**PARITY_POLICY)
    for codec in ("host", "device"):
        cfg = rt.CompressionConfig(eb=5e-2, mode="abs", codec=codec,
                                   eb_policy=pol,
                                   n_levels=ebpolicy.levels_for(pol))
        b_dev, s_dev = rt.compress(u, v, cfg, device=dev)
        b_cpu, s_cpu = rt.compress(u, v, cfg, device="cpu")
        tag = f"parity adaptive codec={codec} {u.shape}"
        assert b_dev == b_cpu, f"{tag}: card and CPU blobs differ"
        header, _ = encode.unpack(b_dev)
        assert header["version"] == 3 \
            and ebpolicy.policy_from_spec(header["eb_policy"]) == pol, \
            f"{tag}: header {header['version']} {header.get('eb_policy')}"
        ur_d, vr_d = rt.decompress(b_dev, device=dev)
        ur_c, vr_c = rt.decompress(b_dev, device="cpu")
        assert np.array_equal(ur_d, ur_c) and np.array_equal(vr_d, vr_c)
        say(f"{tag}: card blob == CPU blob ({len(b_dev)} B, version 3 with "
            f"the policy, n_levels {cfg.n_levels}, verify rounds "
            f"{s_dev['verify_rounds']} {s_dev['verify_bad_counts']}); decode "
            "equal")


def parity_nonfinite(dev, u, v):
    """A field holding NaN, +Inf and -Inf (mode="abs"): card bytes ==
    CPU bytes with both codecs, and the values come back bitwise."""
    import repro_torch as rt

    u = u.copy()
    bad = (37, u.size // 2 + 11, u.size - 5)
    for i, x in zip(bad, (np.nan, np.inf, -np.inf)):
        u.flat[i] = x
    for codec in ("host", "device"):
        cfg = rt.CompressionConfig(eb=1e-2, mode="abs", codec=codec)
        tag = f"parity non-finite codec={codec} {u.shape}"
        with np.errstate(invalid="ignore"):
            b_dev, s_dev = rt.compress(u, v, cfg, device=dev)
            b_cpu, _ = rt.compress(u, v, cfg, device="cpu")
        assert b_dev == b_cpu, f"{tag}: card and CPU blobs differ"
        ur_d, vr_d = rt.decompress(b_dev, device=dev)
        ur_c, vr_c = rt.decompress(b_dev, device="cpu")
        for a, b in ((ur_d, ur_c), (vr_d, vr_c)):
            assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
        got = ur_d.flat[list(bad)].view(np.uint32)
        assert np.array_equal(got, u.flat[list(bad)].view(np.uint32)), \
            f"{tag}: non-finite values not given back bitwise"
        say(f"{tag}: NaN, +Inf, -Inf at flat {bad}: card blob == CPU blob "
            f"({len(b_dev)} B, lossless_frac {s_dev['lossless_frac']:.4f}); "
            "decode equal on both devices, the values back bitwise")


# ----------------------------------------------------------------------
# phase 4: the main path at full size
# ----------------------------------------------------------------------

class Recorder:
    """Routes each kernel dispatch through a recorder for one run:
    CUDA-event time per launch and the inputs of the largest launch (for
    phase 5).  It swaps the ``kernel`` module the ops dispatch calls, so
    the kernel wrappers themselves (and their launch counts) are
    untouched."""

    def __init__(self):
        self.events = {n: [] for n, *_ in KERNELS}
        self.inputs = {}
        self.work = {}
        self._saved = {}

    def __enter__(self):
        import importlib

        by_mod = {}
        for name, mod, attr, _, _ in KERNELS:
            by_mod.setdefault(mod, []).append((name, attr))
        for mod, entries in by_mod.items():
            ops = importlib.import_module(f"repro_torch.kernels.{mod}.ops")
            self._saved[mod] = (ops, ops.kernel)
            ops.kernel = types.SimpleNamespace(
                **{attr: self._wrap(name, getattr(ops.kernel, attr))
                   for name, attr in entries})
        return self

    def __exit__(self, *exc):
        for ops, kmod in self._saved.values():
            ops.kernel = kmod

    def _wrap(self, name, orig):
        def wrapped(*args):
            # inputs kept before the call: verify_faces updates forced
            work = sum(a.numel() for a in args if torch.is_tensor(a))
            if work > self.work.get(name, -1):
                self.work[name] = work
                self.inputs[name] = tuple(
                    a.clone() if torch.is_tensor(a) else a for a in args)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(*args)
            stop.record()
            self.events[name].append((start, stop))
            return out
        return wrapped

    def ms(self):
        torch.cuda.synchronize()
        return {n: sum(a.elapsed_time(b) for a, b in ev)
                for n, ev in self.events.items()}


class StageClock:
    """Host-clock time per pipeline stage for one traced run: each stage
    function is wrapped with a device synchronize on both sides (so the
    sum exceeds an untraced run by the synchronizations)."""

    STAGES = [("fixedpoint", "repro_torch.core.fixedpoint", "to_fixed"),
              ("eb_derive", "repro_torch.core.ebound", "derive_vertex_eb"),
              ("quantize_predict", "repro_torch.core.pipeline",
               "_encode_field"),
              # the verify simulation's and decompress's SL decode
              ("decode_fields", "repro_torch.core.backend", "sl_decode"),
              ("verify_check", "repro_torch.core.pipeline", "_verify_round"),
              ("symbolize", "repro_torch.core.encode", "field_sections"),
              # the device codec's symbolize + code build + bitpack, and
              # its three parts (nested in it)
              ("device_codec", "repro_torch.core.entropy",
               "field_sections_device"),
              ("dc_symbolize", "repro_torch.core.entropy", "symbolize"),
              ("dc_tables", "repro_torch.core.entropy", "build_tables_batch"),
              ("dc_bitpack", "repro_torch.core.entropy", "bitpack"),
              ("pack", "repro_torch.core.encode", "pack"),
              ("unpack", "repro_torch.core.encode", "unpack"),
              # the CPTH1 Huffman decode (nested in unpack)
              ("huffman_decode", "repro_torch.core.entropy", "decode_symbols"),
              ("parse", "repro_torch.core.encode", "parse_field_sections")]

    def __init__(self):
        self.seconds = {}
        self._saved = []

    def __enter__(self):
        import importlib

        for name, mod, attr in self.STAGES:
            m = importlib.import_module(mod)
            orig = getattr(m, attr)
            self._saved.append((m, attr, orig))
            setattr(m, attr, self._wrap(name, orig))
        return self

    def __exit__(self, *exc):
        for m, attr, orig in self._saved:
            setattr(m, attr, orig)

    def _wrap(self, name, orig):
        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*args, **kw)
            torch.cuda.synchronize()
            self.seconds[name] = self.seconds.get(name, 0.0) \
                + time.perf_counter() - t0
            return out
        return timed


def device_profile(fn):
    """Run ``fn()`` under torch.profiler: (wall s, summed device-side
    self time s, top device ops [(name, ms, calls)]).  The device sum is
    0 where the profiler sees no device activity; wall includes the
    profiler's host overhead, so busy = device / wall is a lower bound."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies): a host op's entry
    # repeats the time of the kernels it launched.  "Activity Buffer
    # Request" is the profiler's own buffer, not work of the program.
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key != "Activity Buffer Request"]
    rows = [r for r in rows if r[1] > 0]
    rows.sort(key=lambda r: -r[1])
    return wall, sum(r[1] for r in rows) / 1e3, rows


def kernel_rows(rows):
    """{wrapper name: (device ms, launches)} of this package's kernels
    among profiler rows (the CUDA function is ``<wrapper>_kernel``)."""
    out = {}
    for name, _, attr, _, _ in KERNELS:
        hits = [(ms, c) for n, ms, c in rows if f"{attr}_kernel(" in n]
        out[name] = (sum(h[0] for h in hits), sum(h[1] for h in hits))
    return out


class CallCount:
    """Counts the calls of one module function for a run (``calls``)."""

    def __init__(self, module: str, attr: str):
        self.module, self.attr, self.calls = module, attr, 0

    def __enter__(self):
        import importlib

        self._mod = importlib.import_module(self.module)
        self._orig = orig = getattr(self._mod, self.attr)

        def counted(*args, **kw):
            self.calls += 1
            return orig(*args, **kw)
        setattr(self._mod, self.attr, counted)
        return self

    def __exit__(self, *exc):
        setattr(self._mod, self.attr, self._orig)


def reset_counts(fns):
    for fn in fns.values():
        fn.launches = 0


def read_counts(fns):
    return {n: fn.launches for n, fn in fns.items()}


def check_run(tag, codec, run, u, v, dev, bound=None):
    """The guarantees and launch-count rules of one ``run_main`` run:
    finite output of the field's shape, the pointwise bound (the plan's
    scalar, or ``bound``, an adaptive policy's per-vertex bounds), FC_t =
    FC_s = 0, SL blocks selected, and the launches of every kernel."""
    from repro_torch.core import metrics, trajectory

    stats, blob, (ur, vr) = run["stats"], run["blob"], run["dec"]
    assert ur.shape == u.shape and np.isfinite(ur).all() \
        and np.isfinite(vr).all()
    fc = trajectory.false_cases(u, v, ur, vr, stats["scale"], dev)
    say(f"{tag}: ratio {stats['ratio']:.4f}, "
        f"{len(blob)} B ({blob[:5].decode()}), verify rounds "
        f"{stats['verify_rounds']} {stats['verify_bad_counts']}, "
        f"sl_block_frac {stats['sl_block_frac']:.4f}, lossless_frac "
        f"{stats['lossless_frac']:.4f}")
    if bound is None:
        err = metrics.max_abs_error(u, v, ur, vr)
        say(f"{tag}: max err {float(err)!r} <= eb_abs "
            f"{stats['eb_abs']!r}; FC_t {fc['FC_t']} FC_s {fc['FC_s']} "
            f"(CP_t {fc['CP_t_orig']}, CP_slab {fc['CP_slab_orig']})")
        assert err <= stats["eb_abs"], "pointwise bound violated"
    else:
        err = np.maximum(np.abs(ur.astype(np.float64) - u),
                         np.abs(vr.astype(np.float64) - v))
        n_over = int((err > bound).sum())
        say(f"{tag}: every vertex within its own bound ({n_over} over; "
            f"bounds {bound.min()!r} .. {bound.max()!r}, max err/bound "
            f"{float((err / bound).max())!r}); FC_t {fc['FC_t']} FC_s "
            f"{fc['FC_s']} (CP_t {fc['CP_t_orig']}, CP_slab "
            f"{fc['CP_slab_orig']})")
        assert n_over == 0, f"{tag}: {n_over} vertices over their bound"
    assert fc["FC_t"] == 0 and fc["FC_s"] == 0, f"false cases {fc}"
    assert stats["sl_block_frac"] > 0, "no SL block was selected"
    enc, dec = run["enc_counts"], run["dec_counts"]
    path = [n for n, *_ in KERNELS if n not in TILED_ONLY
            and (codec == "device" or n != "symbol_histogram")]
    for name in path:
        assert enc[name] + dec[name] > 0, f"{tag}: {name} not launched"
    for name in TILED_ONLY:
        assert enc[name] == dec[name] == 0, \
            f"{tag}: {name} ran on the monolithic path"
    rounds = stats["verify_rounds"] + 1
    assert dec["sl_decode"] == 1 and enc["sl_decode"] == rounds, \
        f"{tag}: sl_decode launches {enc['sl_decode']} / " \
        f"{dec['sl_decode']}, expected {rounds} / 1"
    assert enc["sl_step"] == dec["sl_step"] == 0, \
        f"{tag}: the per-frame stepper ran on the main path"
    assert enc["verify_faces"] == rounds \
        and dec["verify_faces"] == 0, \
        f"{tag}: verify_faces launches {enc['verify_faces']}, " \
        f"expected {rounds} (one a verify round)"
    assert enc["sl_step_batched"] == rounds
    assert enc["lorenzo_residual"] == rounds \
        and dec["lorenzo_residual"] == 0, \
        f"{tag}: K1 launches {enc['lorenzo_residual']}, expected " \
        f"{rounds} (one for u and v a verify round)"
    n_dq = enc.pop("dual_quantize")
    assert n_dq == 0, \
        f"{tag}: dual_quantize ran {n_dq} times beside K1 (MoP path)"
    if codec == "host":
        assert enc["symbol_histogram"] == 0
    else:
        assert blob[:5] == b"CPTH1"


def phase_main(dev):
    import repro_torch as rt
    from repro_torch.core import encode
    from repro_torch.data import synthetic

    fns = wrappers()
    results = []
    for T, H, W in SIZES["main"]:
        t0 = time.perf_counter()
        u, v = synthetic.vortex_street(T=T, H=H, W=W)
        say(f"main {T}x{H}x{W}: field generated in "
            f"{time.perf_counter() - t0:.2f} s")
        host_dec = None
        for codec in ("host", "device"):
            tag = f"main {T}x{H}x{W} codec={codec}"
            cfg = rt.CompressionConfig(codec=codec, **scf_meta(T, H, W))
            run = run_main(dev, tag, u, v, cfg, fns)
            check_run(tag, codec, run, u, v, dev)
            blob, (ur, vr) = run["blob"], run["dec"]
            if codec == "host":
                host_dec = (ur, vr)
                want = HOST_ZLIB_BYTES.get((T, H, W))
                if encode.backend_codec() == "zlib" and want is not None:
                    assert len(blob) == want, \
                        f"{tag}: {len(blob)} B, expected {want} B"
                    say(f"{tag}: {len(blob)} B == the host codec's earlier "
                        f"{want} B")
            else:
                assert np.array_equal(ur, host_dec[0]) \
                    and np.array_equal(vr, host_dec[1]), \
                    f"{tag}: decode differs from the host codec's"
                say(f"{tag}: decode == the host codec's decode, bitwise")
            results.append({
                "shape": (T, H, W), "codec": codec, "blob": blob,
                "dec": run["dec"], "dec_s": run["dec_s"],
                "ratio": run["stats"]["ratio"], "enc_s": run["enc_s"],
                "peak_above": run["peak_above"],
                "launches": {n: run["enc_counts"][n] + run["dec_counts"][n]
                             for n in run["enc_counts"]},
                "inputs": run["inputs"],
            })
    return results


# ----------------------------------------------------------------------
# phase 4b: adaptive error bounds at full width
# ----------------------------------------------------------------------

def adaptive_policy(T, H, W, eb):
    """A policy of the shape the reference's rate search builds
    (src/repro/autotune/rate.py: a relaxed default, the protected units
    at ``eb``): 8-frame windows, 4 x 5 tiles, the middle two tile rows
    (the vortex street's wake) at ``eb`` and the rest at 4 ``eb``."""
    from repro_torch.core import ebpolicy

    return ebpolicy.TilePolicy.make(
        8, H // 4, W // 5, default=4 * eb,
        values={(w, ti, tj): eb for w in range(-(-T // 8))
                for ti in (1, 2) for tj in range(5)})


def phase_adaptive(dev, main):
    """compress -> decompress with an adaptive policy (mode="rel") at the
    main sizes: each vertex within its own bound, FC = 0, the launch
    rules of the uniform runs; ratio and peak memory beside the uniform
    run of the same field and codec."""
    import repro_torch as rt
    from repro_torch.core import compressor, ebpolicy
    from repro_torch.data import synthetic

    fns = wrappers()
    eb = 1e-2
    out = []
    for (T, H, W), codecs in SIZES["adaptive"]:
        u, v = synthetic.vortex_street(T=T, H=H, W=W)
        pol = adaptive_policy(T, H, W, eb)
        n_levels = ebpolicy.levels_for(pol)
        assert n_levels == 3, n_levels
        for codec in codecs:
            tag = f"adaptive {T}x{H}x{W} codec={codec}"
            cfg = rt.CompressionConfig(eb=eb, mode="rel", codec=codec,
                                       eb_policy=pol, n_levels=n_levels,
                                       **scf_meta(T, H, W))
            run = run_main(dev, tag, u, v, cfg, fns)
            bound = ebpolicy.field_bounds(
                pol, u.shape, compressor._eb_factor(u, v, cfg))
            check_run(tag, codec, run, u, v, dev, bound)
            uni = next(r for r in main
                       if r["shape"] == (T, H, W) and r["codec"] == codec)
            mib = T * H * W * 8 / 2 ** 20
            say(f"{tag}: ratio {run['stats']['ratio']:.4f} against the "
                f"uniform {uni['ratio']:.4f} (eb {eb} rel; policy "
                f"{len(pol.values)} units at {eb}, default {4 * eb}, "
                f"n_levels {n_levels}); peak device memory "
                f"{run['peak_above']:.1f} MiB above the held, uniform "
                f"{uni['peak_above']:.1f} MiB; the f64 bound tensor "
                f"{mib:.1f} MiB (all rounds) and the int64 caps tensor "
                f"{mib:.1f} MiB (until the clamp)")
            out.append({"shape": (T, H, W), "codec": codec, "policy": pol,
                        "cfg": cfg, "bound": bound, "dec": run["dec"],
                        "ratio": run["stats"]["ratio"],
                        "enc_s": run["enc_s"], "dec_s": run["dec_s"],
                        "peak_above": run["peak_above"]})
    return out


# ----------------------------------------------------------------------
# phase 4c: one traced run with repro_torch.obs
# ----------------------------------------------------------------------

def phase_obs(dev, main):
    """The SCF analogue with tracing on, each codec: the bytes of the
    untraced run, the stage spans, and run_report's byte split summing to
    the container."""
    import repro_torch as rt
    from repro_torch import obs
    from repro_torch.data import synthetic

    T, H, W = SIZES["main"][0]
    u, v = synthetic.vortex_street(T=T, H=H, W=W)
    for codec in ("host", "device"):
        tag = f"obs {T}x{H}x{W} codec={codec}"
        uni = next(r for r in main if r["shape"] == (T, H, W)
                   and r["codec"] == codec)
        cfg = rt.CompressionConfig(codec=codec, **scf_meta(T, H, W))
        obs.reset()
        obs.enable()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob, stats = rt.compress(u, v, cfg, device=dev)
        traced_s = time.perf_counter() - t0
        obs.disable()
        assert blob == uni["blob"], f"{tag}: tracing changed the bytes"
        spans = obs.stage_durations("")
        assert spans["pipeline.verify_round"]["count"] \
            == stats["verify_rounds"] + 1
        rounds = obs.snapshot().get("pipeline.verify_rounds",
                                    {"value": 0})["value"]
        assert rounds == stats["verify_rounds"]
        rep = obs.run_report(blob)
        assert rep["kind_bytes_total"] == rep["container_bytes"] \
            == len(blob), f"{tag}: run_report bytes do not sum to the blob"
        unit = rep["units"][0]
        say(f"{tag}: bytes == the untraced run's; encode {traced_s:.3f} s "
            f"traced, {uni['enc_s']:.3f} s untraced (host clock); span "
            f"seconds (count, sum) "
            f"{json.dumps({k: (d['count'], round(d['sum_s'], 5)) for k, d in spans.items()})}; "
            f"pipeline.verify_rounds {rounds}")
        say(f"{tag}: run_report {rep['container']} bytes_by_kind "
            f"{json.dumps(rep['bytes_by_kind'])} == {len(blob)} B; achieved "
            f"{unit['achieved_bps']} bits/symbol, Shannon "
            f"{unit['shannon_bps']}")


# ----------------------------------------------------------------------
# phase 4d: tiled containers at full width
# ----------------------------------------------------------------------

def tiled_groups(shape, grid):
    """(predicate groups, entropy groups) of a tiled compress: the track
    index evaluates each window's units one launch per extension
    geometry that owns tets, the device codec codes them one launch per
    owned shape (core/tiling.py)."""
    from repro_torch.core import tiling

    T, H, W = shape
    seg, ent = set(), set()
    for s in tiling.plan(shape, grid):
        own = (min(s.t1, T - 1) - s.t0, min(s.i1, H - 1) - s.i0,
               min(s.j1, W - 1) - s.j0)
        if min(own) > 0:
            seg.add((s.wi,) + s.ext_shape + s.owned[:3] + own)
        ent.add((s.wi,) + s.owned_shape)
    return len(seg), len(ent)


def check_tiled_launches(tag, codec, stats, enc, dec, groups):
    """One launch per signature chunk, per kernel: a chunk of several
    units through the unit-batched entries (K1, K4, K3 where a unit has
    SL blocks, K2), a lone unit through the whole-field ones (K1 twice:
    X over the extension, residuals over the owned box)."""
    want = check_encode_launches(tag, codec, stats, enc, groups)
    assert all(dec[k] == 0 for k in want if k in dec and k != "sl_decode") \
        and 0 < dec["sl_decode"] <= stats["n_units"], \
        f"{tag}: decompress launches {dec}"


def check_encode_launches(tag, codec, stats, enc, groups):
    """The compress half of check_tiled_launches (a tiled or streamed
    compress).  Returns the expected counts."""
    v, e = stats["chunks"]["verify"], stats["chunks"]["emit"]
    n_seg, n_ent = groups
    want = {
        "lorenzo_residual_units": v["multi"] + e["multi"],
        "lorenzo_residual": 2 * (v["single"] + e["single"]),
        "sl_step_batched": v["multi"] + v["single"] + e["multi"]
        + e["single"],
        "sl_decode_units": v["sl_multi"],
        "sl_decode": v["sl_single"],
        "verify_faces_units": v["multi"],
        "verify_faces": v["single"],
        "face_crossed": n_seg,
        "symbol_histogram": n_ent if codec == "device" else 0,
        "sl_step": 0,
        "dual_quantize": 0,
    }
    got = {k: enc[k] for k in want}
    assert got == want, f"{tag}: launches {got}, expected {want}"
    units = stats["n_units"] * (stats["verify_rounds"] + 1)
    assert v["multi"] > 0 and v["multi"] + v["single"] < units, \
        f"{tag}: {v['multi'] + v['single']} verify chunks for {units} " \
        "unit rounds"
    return want


def phase_tiled(dev, main, adaptive):
    """compress_tiled -> decompress at full width with TileGrid(128, 128,
    32): the SCF analogue and 64x512x512 with each codec, and the
    adaptive policy at the SCF analogue with codec="device".  Returns
    the 64x512x512 device-codec run (phase 5's unit-kernel inputs) and
    {(shape, codec): blob, stats, decode, seconds} of the uniform runs."""
    import repro_torch as rt
    from repro_torch.analysis import query
    from repro_torch.data import synthetic

    fns = wrappers()
    grid = rt.TileGrid(*SIZES["tile_grid"])
    table_run = None
    cases = [(shape, codec, None) for shape, codecs in SIZES["tiled"]
             for codec in codecs]
    ad = next(a for a in adaptive if a["shape"] == SIZES["main"][0]
              and a["codec"] == "device")
    cases.append((ad["shape"], "device", ad))
    fields = {}
    runs = {}
    for (T, H, W), codec, pol_run in cases:
        if (T, H, W) not in fields:
            fields[(T, H, W)] = synthetic.vortex_street(T=T, H=H, W=W)
        u, v = fields[(T, H, W)]
        if pol_run is None:
            tag = f"tiled {T}x{H}x{W} codec={codec}"
            cfg = rt.CompressionConfig(codec=codec, tiling=grid,
                                       **scf_meta(T, H, W))
            mono = next(r for r in main if r["shape"] == (T, H, W)
                        and r["codec"] == codec)
        else:
            tag = f"tiled adaptive {T}x{H}x{W} codec={codec}"
            cfg = dataclasses.replace(pol_run["cfg"], tiling=grid)
            mono = pol_run
        run = run_tiled(dev, tag, u, v, cfg, fns)
        stats, blob, (ur, vr) = run["stats"], run["blob"], run["dec"]
        check_tiled_launches(tag, codec, stats, run["enc_counts"],
                             run["dec_counts"], tiled_groups((T, H, W), grid))
        assert np.array_equal(ur, mono["dec"][0]) \
            and np.array_equal(vr, mono["dec"][1]), \
            f"{tag}: tiled decode differs from the monolithic decode"
        check_guarantees(tag, u, v, ur, vr, stats, dev,
                         None if pol_run is None else pol_run["bound"])
        src = query.ContainerSource(blob)
        src.header()
        reads = src.reads
        region = (T // 2, T // 2 + 1, 1, 2, 1, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ru, rv = rt.decompress_region(src, region, device=dev)
        region_s = time.perf_counter() - t0
        assert src.reads - reads == 1 and len(rt.read_plan(blob, region)) == 1
        assert ru[0, 0, 0] == ur[region[0], 1, 1]
        say(f"{tag}: ratio {stats['ratio']:.4f} (monolithic "
            f"{mono['ratio']:.4f}), {len(blob)} B, {stats['n_units']} units, "
            f"verify rounds {stats['verify_rounds']} "
            f"{stats['verify_bad_counts']}, chunks "
            f"{json.dumps(stats['chunks'])}; tiled decode == monolithic "
            f"decode, bitwise")
        say(f"{tag}: encode {run['enc_s']:.3f} s (monolithic "
            f"{mono['enc_s']:.3f} s), decode {run['dec_s']:.3f} s "
            f"(monolithic {mono['dec_s']:.3f} s), second call, host clock; "
            f"peak device memory {run['peak_above']:.1f} MiB above the held "
            f"(monolithic {mono['peak_above']:.1f} MiB); decompress_region "
            f"{region} read 1 unit in {region_s:.4f} s")
        if (T, H, W) == SIZES["tiled"][-1][0] and codec == "device" \
                and pol_run is None:
            table_run = run
        if pol_run is None:
            runs[(T, H, W), codec] = {k: run[k] for k in
                                      ("blob", "stats", "dec", "enc_s",
                                       "dec_s", "peak_above")}
    return table_run, runs


def check_guarantees(tag, u, v, ur, vr, stats, dev, bound=None):
    """Finite output of the field's shape, the pointwise bound (scalar or
    per-vertex) and FC_t = FC_s = 0."""
    from repro_torch.core import trajectory

    assert ur.shape == u.shape and np.isfinite(ur).all() \
        and np.isfinite(vr).all()
    err = np.maximum(np.abs(ur.astype(np.float64) - u),
                     np.abs(vr.astype(np.float64) - v))
    lim = stats["eb_abs"] if bound is None else bound
    assert (err <= lim).all(), f"{tag}: pointwise bound violated"
    fc = trajectory.false_cases(u, v, ur, vr, stats["scale"], dev)
    assert fc["FC_t"] == 0 and fc["FC_s"] == 0, f"{tag}: false cases {fc}"
    say(f"{tag}: max err / bound {float((err / lim).max())!r}, FC_t "
        f"{fc['FC_t']} FC_s {fc['FC_s']} (CP_t {fc['CP_t_orig']})")


class TiledClock(StageClock):
    """Host-clock seconds per stage of one tiled compress -> decompress
    (each stage synchronized on both sides; the verify chunks hold their
    encode, and unit_payloads its encode and track-index segments)."""

    STAGES = [
        ("derive_window", "repro_torch.core.tiling", "_derive_window"),
        ("verify_chunk", "repro_torch.core.tiling", "_round_chunk"),
        ("encode_chunk", "repro_torch.core.tiling", "_encode_chunk"),
        ("index_segments", "repro_torch.core.tiling",
         "_window_segment_records"),
        ("unit_payloads", "repro_torch.core.tiling", "_unit_payloads"),
        ("entropy_fragments", "repro_torch.core.tiling",
         "_attach_entropy_fragments"),
        ("write_unit", "repro_torch.core.tiling", "_write_unit"),
        ("finish_header", "repro_torch.core.tiling", "_finish_header"),
        # a full decode reads unit by unit past the decoded-unit cache
        ("decode_units", "repro_torch.core.pipeline", "decode_payload"),
    ]


def run_tiled(dev, tag, u, v, cfg, fns):
    """One field through compress -> decompress with tiling on the card:
    a recorded run with launch counts (the kernel inputs kept for phase
    5), then a second, uninstrumented run for host-clock seconds and
    peak memory."""
    import repro_torch as rt

    with Recorder() as rec, CallCount("repro_torch.core.quantize",
                                      "dual_quantize") as dq:
        reset_counts(fns)
        dq.calls = 0
        blob, stats = rt.compress(u, v, cfg, device=dev)
        enc_counts = read_counts(fns)
        enc_counts["dual_quantize"] = dq.calls
        reset_counts(fns)
        ur, vr = rt.decompress(blob, device=dev)
        dec_counts = read_counts(fns)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    blob2, _ = rt.compress(u, v, cfg, device=dev)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ur2, vr2 = rt.decompress(blob2, device=dev)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    assert blob2 == blob and np.array_equal(ur2, ur) \
        and np.array_equal(vr2, vr), f"{tag}: runs differ"
    with TiledClock() as clock:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob3, _ = rt.compress(u, v, cfg, device=dev)
        traced_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        rt.decompress(blob3, device=dev)
        traced_dec = time.perf_counter() - t0
    say(f"{tag}: traced run encode {traced_enc:.3f} s, decode "
        f"{traced_dec:.3f} s; stage seconds "
        f"{json.dumps({k: round(x, 4) for k, x in clock.seconds.items()})}")
    say(f"{tag}: launches compress {json.dumps(enc_counts)}, decompress "
        f"{json.dumps(dec_counts)}")
    return {"blob": blob, "stats": stats, "dec": (ur, vr),
            "enc_counts": enc_counts, "dec_counts": dec_counts,
            "inputs": rec.inputs, "peak_above": (peak - held) / 2 ** 20,
            "enc_s": enc_s, "dec_s": dec_s,
            "launches": {n: enc_counts[n] + dec_counts[n]
                         for n in dec_counts}}


def run_main(dev, tag, u, v, cfg, fns):
    """One field through compress -> decompress on the card: a recorded
    run with launch counts, a timed run, a traced run and a profiled run.
    Returns the first run's blob, stats, decode, counts and inputs."""
    import repro_torch as rt

    with Recorder() as rec, CallCount("repro_torch.core.quantize",
                                      "dual_quantize") as dq:
        reset_counts(fns)
        dq.calls = 0
        blob, stats = rt.compress(u, v, cfg, device=dev)
        enc_counts = read_counts(fns)
        enc_counts["dual_quantize"] = dq.calls
        reset_counts(fns)
        ur, vr = rt.decompress(blob, device=dev)
        dec_counts = read_counts(fns)
        kernel_ms = rec.ms()
    # second, uninstrumented run for the host-clock times
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # held: the recorded kernel inputs (phase 5's) and cached tables
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    blob2, _ = rt.compress(u, v, cfg, device=dev)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ur2, vr2 = rt.decompress(blob2, device=dev)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    with StageClock() as clock:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob3, _ = rt.compress(u, v, cfg, device=dev)
        torch.cuda.synchronize()
        traced_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        rt.decompress(blob3, device=dev)
        torch.cuda.synchronize()
        traced_dec = time.perf_counter() - t0
    say(f"{tag}: traced run encode {traced_enc:.3f} s, "
        f"decode {traced_dec:.3f} s; stage seconds "
        f"{json.dumps({k: round(x, 4) for k, x in clock.seconds.items()})}")
    for what, fn in (("compress", lambda: rt.compress(u, v, cfg, device=dev)),
                     ("decompress", lambda: rt.decompress(blob, device=dev))):
        wall, busy, rows = device_profile(fn)
        say(f"{tag}: profiled {what}: wall {wall:.3f} s, "
            f"device busy {busy:.4f} s ({100 * busy / wall:.2f}%); "
            f"kernels (device ms, launches) "
            f"{json.dumps(kernel_rows(rows))}; top device ops (name, ms, "
            f"calls) "
            f"{json.dumps([(n[:60], round(ms, 3), c) for n, ms, c in rows[:6]])}")
    assert blob2 == blob == blob3, "compress runs gave different bytes"
    assert np.array_equal(ur2, ur) and np.array_equal(vr2, vr)
    say(f"{tag}: encode {enc_s:.3f} s, decode {dec_s:.3f} s "
        f"(second call, host clock), peak device memory "
        f"{peak / 2 ** 20:.1f} MiB ({(peak - held) / 2 ** 20:.1f} MiB above "
        f"the {held / 2 ** 20:.1f} MiB held before the call)")
    say(f"{tag}: launches compress {json.dumps(enc_counts)}, "
        f"decompress {json.dumps(dec_counts)}; summed stream ms per "
        f"kernel (CUDA events around each call, host gaps included) "
        f"{json.dumps({k: round(x, 4) for k, x in kernel_ms.items()})}")
    return {"blob": blob, "stats": stats, "dec": (ur, vr),
            "enc_counts": enc_counts, "dec_counts": dec_counts,
            "inputs": rec.inputs, "peak_above": (peak - held) / 2 ** 20,
            "enc_s": enc_s, "dec_s": dec_s}


# ----------------------------------------------------------------------
# phase 4e: streaming compression at full width
# ----------------------------------------------------------------------

class ThreadLog:
    """The threads each kernel wrapper was called from, for one run
    (``threads[name]``: set of ``threading.get_ident()``).  Like
    Recorder, it swaps the ``kernel`` module the ops dispatch calls; the
    wrappers' launch counts are untouched."""

    def __init__(self):
        self.threads = {n: set() for n, *_ in KERNELS}
        self._saved = {}

    def __enter__(self):
        import importlib
        import threading

        by_mod = {}
        for name, mod, attr, _, _ in KERNELS:
            by_mod.setdefault(mod, []).append((name, attr))
        for mod, entries in by_mod.items():
            ops = importlib.import_module(f"repro_torch.kernels.{mod}.ops")
            self._saved[mod] = (ops, ops.kernel)

            def wrap(name, orig):
                def logged(*args):
                    self.threads[name].add(threading.get_ident())
                    return orig(*args)
                return logged
            ops.kernel = types.SimpleNamespace(
                **{attr: wrap(name, getattr(ops.kernel, attr))
                   for name, attr in entries})
        return self

    def __exit__(self, *exc):
        for ops, kmod in self._saved.values():
            ops.kernel = kmod

    def off_thread(self, ident):
        return {n: sorted(t - {ident}) for n, t in self.threads.items()
                if t - {ident}}


class ResidentFrames:
    """After every frame a stream takes: the frames resident in each
    plane store (u, v, ufp, vfp, eb, forced and, under a policy, ebf)
    must all lie at or after the first pending window's t0 - thalo (the
    reference scheduler's bound); ``peak`` is the most frames any store
    held."""

    def __init__(self):
        self.peak = 0

    def __enter__(self):
        from repro_torch.core import stream_engine

        self._cls = stream_engine.Scheduler
        self._orig = orig = self._cls.add_frame
        rec = self

        def add_frame(sched, *args):
            orig(sched, *args)
            st = sched.st
            stores = [st.u, st.v, st.ufp, st.vfp, st.eb, st.forced] \
                + ([st.ebf] if st.ebf is not None else [])
            lo = sched.pending[0].t0 - sched.grid.thalo if sched.pending \
                else 0
            for planes in stores:
                assert min(planes.p, default=lo) >= lo, \
                    f"frame {min(planes.p)} resident below {lo}"
            rec.peak = max(rec.peak, max(len(p.p) for p in stores))
        self._cls.add_frame = add_frame
        return self

    def __exit__(self, *exc):
        self._cls.add_frame = self._orig


def stream_bound(T, grid):
    """The most frames the scheduler holds after a frame: 3 windows + 2
    halos - 1 in steady state (the frame before a window's derivation,
    kept from two windows back less a halo), the whole stream when it
    is shorter (a window is written only once the next is derived)."""
    return min(T, 3 * grid.window_t + 2 * grid.thalo - 1)


def run_stream(dev, tag, u, v, cfg, grid, async_engine, fns):
    """One counted stream of (u, v) frame by frame from a generator:
    launches, the threads of every kernel call, resident frames, host
    seconds, peak device memory above the held."""
    import threading

    import repro_torch as rt

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with ThreadLog() as log, ResidentFrames() as res, \
            CallCount("repro_torch.core.quantize", "dual_quantize") as dq:
        reset_counts(fns)
        t0 = time.perf_counter()
        blob, stats = rt.compress_stream(frames(u, v), cfg, grid,
                                         value_range=value_range(u, v),
                                         async_engine=async_engine,
                                         device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts(fns)
        counts["dual_quantize"] = dq.calls
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
    off = log.off_thread(threading.get_ident())
    assert not off, f"{tag}: kernels launched off the caller's thread {off}"
    bound = stream_bound(u.shape[0], grid)
    assert res.peak <= bound, f"{tag}: {res.peak} frames resident > {bound}"
    assert stats["async_engine"] is async_engine
    return {"blob": blob, "stats": stats, "counts": counts, "s": secs,
            "peak_above": peak, "resident": res.peak, "bound": bound}


def phase_stream(dev, tiled_runs):
    """compress_stream of vortex_street(64, 512, 512) frame by frame with
    TileGrid(128, 128, 32), each codec, each engine: the tiled phase's
    bytes, one launch per chunk, every kernel on the caller's thread, the
    resident-frame bound, seconds, the async / serial ratio and the
    device busy share; then one async device-codec stream of T = 128.
    Returns the host-codec stream blob."""
    import repro_torch as rt
    from repro_torch.data import synthetic

    fns = wrappers()
    grid = rt.TileGrid(*SIZES["tile_grid"])
    T, H, W = SIZES["stream"]
    u, v = synthetic.vortex_street(T=T, H=H, W=W)
    groups = tiled_groups((T, H, W), grid)
    out = {}
    for codec in ("host", "device"):
        cfg = rt.CompressionConfig(codec=codec, **scf_meta(T, H, W))
        tiled = tiled_runs[(T, H, W), codec]
        secs = {}
        for engine in ("serial", "async"):
            tag = f"stream {T}x{H}x{W} codec={codec} {engine}"
            run = run_stream(dev, tag, u, v, cfg, grid, engine == "async",
                             fns)
            stats = run["stats"]
            assert run["blob"] == tiled["blob"], \
                f"{tag}: stream bytes differ from compress_tiled's"
            check_encode_launches(tag, codec, stats, run["counts"], groups)
            secs[engine] = run["s"]
            out[codec, engine] = run
            wall, busy, rows = device_profile(
                lambda: rt.compress_stream(
                    frames(u, v), cfg, grid, value_range=value_range(u, v),
                    async_engine=engine == "async", device=dev))
            say(f"{tag}: bytes == compress_tiled's ({len(run['blob'])} B, "
                f"{stats['n_units']} units); {run['s']:.3f} s host clock "
                f"(compress_tiled {tiled['enc_s']:.3f} s); all kernels on "
                f"the caller's thread; resident frames at most "
                f"{run['resident']} (bound {run['bound']}); peak device "
                f"memory {run['peak_above']:.1f} MiB above the held "
                f"(compress_tiled {tiled['peak_above']:.1f} MiB); profiled: "
                f"wall {wall:.3f} s, device busy {busy:.4f} s "
                f"({100 * busy / wall:.2f}%)")
            say(f"{tag}: launches {json.dumps(run['counts'])} == the chunk "
                f"counts {json.dumps(stats['chunks'])}")
        say(f"stream {T}x{H}x{W} codec={codec}: async / serial "
            f"{secs['async'] / secs['serial']:.4f} ({secs['async']:.3f} / "
            f"{secs['serial']:.3f} s)")
    # a longer stream: the frames held and the device memory do not grow
    TL = SIZES["stream_long"]
    ul, vl = synthetic.vortex_street(T=TL, H=H, W=W)
    cfg = rt.CompressionConfig(codec="device", **scf_meta(TL, H, W))
    tag = f"stream {TL}x{H}x{W} codec=device async"
    long = run_stream(dev, tag, ul, vl, cfg, grid, True, fns)
    short = out["device", "async"]
    check_encode_launches(tag, "device", long["stats"], long["counts"],
                          tiled_groups((TL, H, W), grid))
    say(f"{tag}: {long['s']:.3f} s ({long['s'] / short['s']:.3f} x the "
        f"{T}-frame stream), resident frames at most {long['resident']} "
        f"(bound {long['bound']}; the {T}-frame stream held "
        f"{short['resident']}, all of its frames), peak device memory "
        f"{long['peak_above']:.1f} MiB above the held ({T} frames: "
        f"{short['peak_above']:.1f} MiB, ratio "
        f"{long['peak_above'] / short['peak_above']:.4f}), ratio "
        f"{long['stats']['ratio']:.4f}")
    assert long["peak_above"] <= 1.05 * short["peak_above"], \
        f"{tag}: peak device memory grew with the stream's length"
    assert long["resident"] == stream_bound(TL, grid) < TL
    return out["host", "serial"]["blob"]


# ----------------------------------------------------------------------
# phase 4f: crash recovery
# ----------------------------------------------------------------------

_KILL_CHILD = r"""
import os, signal, sys, time
sys.path.insert(0, sys.argv[1])
import repro_torch as rt
from repro_torch.core import stream_engine
from repro_torch.data import synthetic

T, H, W, kill_at, th, tw, wt = (int(x) for x in sys.argv[2:9])
engine, path, device = sys.argv[9:12]
u, v = synthetic.vortex_street(T=T, H=H, W=W)
vr = (float(min(u.min(), v.min())), float(max(u.max(), v.max())))

def frames():
    for t in range(T):
        if t == kill_at:
            # the async engine's writer makes a checkpoint durable after
            # the ingest has read ahead: die once one is on disk, so the
            # resume splices on both engines (serial: already there)
            deadline = time.monotonic() + 120
            while stream_engine.resume_info(path)["resume_from"] == 0 \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
            os.kill(os.getpid(), signal.SIGKILL)
        yield u[t], v[t]

rt.compress_stream(frames(), rt.CompressionConfig(
    dt=0.05, dx=2.0 / (W - 1), dy=1.0 / (H - 1)),
    rt.TileGrid(th, tw, wt), value_range=vr, sink=path,
    async_engine=engine == "async", device=device)
"""


def phase_recovery(dev, stream_blob, tiled_runs):
    """Kill-and-resume on the card at the SCF analogue: a fresh
    interpreter SIGKILLs itself before a mid-stream frame and before the
    last frame, on each engine, and resume=True finishes the
    uninterrupted bytes; salvage of the 64x512x512 stream container cut
    before its footer recovers every unit; a degraded decode of a copy
    with one unit's byte flipped reports exactly that unit."""
    import repro_torch as rt
    from repro_torch.core import encode, stream_engine
    from repro_torch.data import synthetic

    T, H, W = SIZES["main"][0]
    grid = rt.TileGrid(*SIZES["tile_grid"])
    u, v = synthetic.vortex_street(T=T, H=H, W=W)
    cfg = rt.CompressionConfig(**scf_meta(T, H, W))
    want = tiled_runs[(T, H, W), "host"]["blob"]
    work = ROOT / "build" / "recovery"
    work.mkdir(parents=True, exist_ok=True)
    for engine in ("serial", "async"):
        for kill_at in SIZES["kill_at"]:
            tag = f"recovery {T}x{H}x{W} {engine} kill before frame {kill_at}"
            path = work / f"{engine}-{kill_at}.cptt"
            for f in (path, Path(f"{path}.journal")):
                if f.exists():
                    f.unlink()
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-c", _KILL_CHILD, str(ROOT / "src"),
                 *(str(x) for x in (T, H, W, kill_at) + SIZES["tile_grid"]),
                 engine, str(path), str(dev)],
                capture_output=True, text=True, timeout=600)
            child_s = time.perf_counter() - t0
            assert res.returncode == -9, \
                f"{tag}: child exited {res.returncode}: {res.stderr[-3000:]}"
            info = stream_engine.resume_info(str(path))
            assert info["resumable"] and not info["complete"] \
                and info["resume_from"] > 0, info
            t0 = time.perf_counter()
            _, st = rt.compress_stream(
                lambda t: frames(u[t:], v[t:]), cfg, grid,
                value_range=value_range(u, v), sink=str(path), resume=True,
                async_engine=engine == "async", device=dev)
            resume_s = time.perf_counter() - t0
            assert path.read_bytes() == want, \
                f"{tag}: resumed container differs from the uninterrupted"
            assert st["resumed_from"] == info["resume_from"]
            assert not Path(f"{path}.journal").exists()
            say(f"{tag}: child killed by SIGKILL after {child_s:.2f} s with "
                f"{info['n_units']} units ({info['bytes']} B) durable; "
                f"resume from frame {info['resume_from']} in {resume_s:.3f} "
                f"s; container == the uninterrupted one ({len(want)} B)")
            path.unlink()
    # salvage and a degraded decode of the 64x512x512 stream container
    TS, HS, WS = SIZES["stream"]
    ref = tiled_runs[(TS, HS, WS), "host"]
    units = encode.tiled_header(stream_blob)["units"]
    last = max(units, key=lambda e: e["off"])
    cut = stream_blob[: last["off"] + last["len"]]
    t0 = time.perf_counter()
    salvaged, rep = encode.salvage_container(cut)
    salvage_s = time.perf_counter() - t0
    assert rep["units_recovered"] == len(units) and rep["prologue_recovered"]
    su, sv = rt.decompress_tiled(salvaged, device=dev)
    assert np.array_equal(su, ref["dec"][0]) \
        and np.array_equal(sv, ref["dec"][1])
    say(f"recovery salvage {TS}x{HS}x{WS}: the stream container cut before "
        f"its footer ({len(cut)} of {len(stream_blob)} B) -> "
        f"{rep['units_recovered']} of {len(units)} units in "
        f"{salvage_s:.3f} s; decode == the clean decode")
    entry = units[len(units) // 2]
    bad = bytearray(stream_blob)
    bad[entry["off"] + entry["len"] // 2] ^= 0x20
    t0 = time.perf_counter()
    du, dv, drep = rt.decompress_tiled(bytes(bad), device=dev, degraded=True)
    degraded_s = time.perf_counter() - t0
    assert [m["key"] for m in drep.missing_units] == [tuple(entry["key"])]
    hole = drep.hole_mask((0, TS, 0, HS, 0, WS))
    t0_, t1_, i0, i1, j0, j1 = entry["box"]
    assert hole.sum() == (t1_ - t0_) * (i1 - i0) * (j1 - j0) \
        and hole[t0_:t1_, i0:i1, j0:j1].all()
    assert not du[hole].any() and not dv[hole].any()
    assert np.array_equal(du[~hole], ref["dec"][0][~hole]) \
        and np.array_equal(dv[~hole], ref["dec"][1][~hole])
    say(f"recovery degraded {TS}x{HS}x{WS}: one byte flipped in unit "
        f"{entry['key']} -> reported missing exactly that unit, its box "
        f"holes, the rest == the clean decode ({drep.n_decoded} of "
        f"{drep.n_units} units, {degraded_s:.3f} s)")


# ----------------------------------------------------------------------
# phase 4g: track queries on the tiled container
# ----------------------------------------------------------------------

def phase_query(dev, tiled_runs):
    """The track index of the 64x512x512 host-codec tiled container:
    track_summaries == the tracks of extraction.extract over the full
    decode; for the longest track, track_read_plan's units,
    decode_for_track's polyline == the full extraction's bitwise, and a
    warm query reads less than a cold one; launches of one cold query."""
    from repro_torch import analysis
    from repro_torch.analysis import extraction, query
    from repro_torch.core import fixedpoint

    fns = wrappers()
    T, H, W = SIZES["stream"]
    run = tiled_runs[(T, H, W), "host"]
    blob = run["blob"]
    t0 = time.perf_counter()
    summaries = analysis.track_summaries(blob)
    sum_s = time.perf_counter() - t0
    ufp, vfp = fixedpoint.refix(*run["dec"], run["stats"]["scale"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = extraction.extract(ufp, vfp, device=dev)
    extract_s = time.perf_counter() - t0
    assert full.n_tracks == len(summaries) > 0, \
        f"query: {full.n_tracks} extracted tracks, {len(summaries)} indexed"
    for s in summaries:
        tr = full.track(s["track_id"])
        assert s["n_nodes"] == len(tr.face_ids), s
        assert s["n_segments"] == int(
            (full.track_of[full.edges[:, 0]] == s["track_id"]).sum()), s
    k = max(summaries, key=lambda s: s["n_nodes"])["track_id"]
    plan = analysis.track_read_plan(blob, k)
    query.configure_unit_cache(256)
    reset_counts(fns)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cold = analysis.decode_for_track(blob, k, device=dev)
    cold_s = time.perf_counter() - t0
    counts = read_counts(fns)
    t0 = time.perf_counter()
    warm = analysis.decode_for_track(blob, k, device=dev)
    warm_s = time.perf_counter() - t0
    ref = full.track(k)
    for res in (cold, warm):
        assert np.array_equal(res.track.face_ids, ref.face_ids) \
            and np.array_equal(res.track.nodes, ref.nodes) \
            and np.array_equal(res.track.types, ref.types), \
            "query: decode_for_track's polyline differs from the extraction"
    assert cold.entries == plan and cold.units_read == len(plan) \
        < cold.units_total
    assert warm.range_reads < cold.range_reads \
        and warm.cache_hits == warm.units_read
    assert counts["sl_decode"] + counts["sl_decode_units"] > 0
    say(f"query {T}x{H}x{W}: {len(summaries)} indexed tracks == "
        f"extraction.extract of the full decode ({full.n_nodes} nodes; "
        f"summaries {sum_s:.4f} s, extract {extract_s:.3f} s, full decode "
        f"{run.get('dec_s', float('nan')):.3f} s); longest track {k} "
        f"({len(ref.face_ids)} nodes): read plan {len(plan)} of "
        f"{cold.units_total} units ({cold.bytes_read} B), polyline == the "
        f"extraction's bitwise; cold {cold_s:.4f} s, {cold.range_reads} "
        f"range reads; warm {warm_s:.4f} s, {warm.range_reads} range "
        f"reads, {warm.cache_hits} cache hits")
    say(f"query {T}x{H}x{W}: launches of the cold decode_for_track "
        f"{json.dumps(counts)}")


# ----------------------------------------------------------------------
# phase 4h: plan autotuning, rate-targeted compression, the baselines
# ----------------------------------------------------------------------

def check_path_launches(tag, codec, counts):
    """Every kernel of a compress -> decompress launched at least once
    (the whole-field or the unit-batched entry), the per-frame stepper
    never."""
    pairs = [("K1", ("lorenzo_residual", "lorenzo_residual_units")),
             ("K2", ("verify_faces", "verify_faces_units")),
             ("K3", ("sl_decode", "sl_decode_units")),
             ("K4", ("sl_step_batched",))]
    if codec == "device":
        pairs.append(("K5", ("symbol_histogram",)))
    for k, names in pairs:
        assert sum(counts[n] for n in names) > 0, \
            f"{tag}: {k} ({' / '.join(names)}) not launched"
    assert counts["sl_step"] == 0, f"{tag}: the per-frame stepper ran"


def counted(fns, fn):
    """(fn(), launches of every kernel in the call)."""
    reset_counts(fns)
    out = fn()
    return out, read_counts(fns)


def hand_set(cfg, tuned):
    """The tuned plan configured by hand from its fields."""
    import repro_torch as rt

    g = tuned.tiling
    return dataclasses.replace(
        cfg, codec=tuned.codec, batch_units=tuned.batch_units,
        batch_cap=tuned.batch_cap, q_in_frames=tuned.q_in_frames,
        q_out_units=tuned.q_out_units,
        tiling=None if g is None else rt.TileGrid(
            tile_h=g.tile_h, tile_w=g.tile_w, window_t=g.window_t))


def timed_compress(dev, u, v, cfg):
    """Host-clock seconds of one synchronized compress (a second call)."""
    import repro_torch as rt

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blob, _ = rt.compress(u, v, cfg, device=dev)
    torch.cuda.synchronize()
    return blob, time.perf_counter() - t0


def phase_autotune(dev, main):
    """Calibration on the card, measured tunes at the two main sizes, a
    tuned 64-frame stream, the rate search at the SCF analogue and the
    baselines there."""
    import tempfile

    import repro_torch as rt
    from repro_torch import autotune, baselines
    from repro_torch.autotune import costmodel
    from repro_torch.core import compressor, ebpolicy, encode, fixedpoint, \
        trajectory
    from repro_torch.data import synthetic

    fns = wrappers()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp, \
            TablePath(Path(tmp) / "autotune_calib.json") as tp:
        t0 = time.perf_counter()
        table = autotune.calibrate(path=tp.path, device=dev)
        calib_s = time.perf_counter() - t0
        kind = autotune.device_kind(dev)
        assert set(table.coeffs) == {(kind, st) for st in costmodel.STAGES}, \
            sorted(table.coeffs)
        assert all(c0 >= 0 and c1 >= 0 for c0, c1 in table.coeffs.values())
        say(f"autotune calibration on the card at {table.meta['shapes']} "
            f"in {calib_s:.2f} s: (c0 s a dispatch, c1 s an element) "
            + json.dumps({st: table.coeffs[kind, st]
                          for st in costmodel.STAGES}))

        for T, H, W in SIZES["main"]:
            u, v = synthetic.vortex_street(T=T, H=H, W=W)
            cfg = rt.CompressionConfig(**scf_meta(T, H, W))
            tag = f"autotune {T}x{H}x{W}"
            t0 = time.perf_counter()
            tuned = autotune.tune_config(u, v, cfg, table=table, device=dev)
            tune_s = time.perf_counter() - t0
            rep = autotune.last_report()
            measured = [p for p in rep["plans"] if p["measured_s"] is not None]
            assert len(measured) == 3 and rep["plans"][0]["chosen"]
            sample = autotune._sample(u, v)[0].shape
            say(f"{tag}: tuned in {tune_s:.2f} s over "
                f"{len(rep['plans'])} candidates; measured on {sample}: "
                + "; ".join(f"{p['plan']} predicted {p['predicted_s']:.6f} s "
                            f"(full field), measured {p['measured_s']:.6f} s"
                            for p in measured)
                + f"; chosen {rep['chosen']}")
            (blob, stats), enc = counted(
                fns, lambda: rt.compress(u, v, tuned, device=dev))
            (ur, vr), dec = counted(fns, lambda: rt.decompress(blob,
                                                               device=dev))
            launches = {n: enc[n] + dec[n] for n in enc}
            check_path_launches(tag, tuned.codec, launches)
            check_guarantees(tag, u, v, ur, vr, stats, dev)
            hand = hand_set(cfg, tuned)
            blob_hand, chosen_s = timed_compress(dev, u, v, hand)
            assert blob_hand == blob, f"{tag}: tuned bytes != hand-set bytes"
            mono = next(r for r in main if r["shape"] == (T, H, W)
                        and r["codec"] == "host")
            say(f"{tag}: chosen {rep['chosen']} bytes == the plan set by "
                f"hand ({len(blob)} B, ratio {stats['ratio']:.4f}); encode "
                f"{chosen_s:.3f} s against the default monolithic plan's "
                f"{mono['enc_s']:.3f} s (ratio {mono['ratio']:.4f}), second "
                f"call, host clock; launches compress {json.dumps(enc)}, "
                f"decompress {json.dumps(dec)}")

        T, H, W = SIZES["stream"]
        u, v = synthetic.vortex_street(T=T, H=H, W=W)
        cfg = rt.CompressionConfig(**scf_meta(T, H, W))
        tag = f"autotune stream {T}x{H}x{W}"
        tuned, cand = autotune.tune_stream((T, H, W), cfg, table=table,
                                           device=dev)
        chosen = autotune.last_report()["chosen"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (blob, stats), counts = counted(fns, lambda: rt.compress_stream(
            frames(u, v), cfg, autotune=True, n_frames_hint=T,
            value_range=value_range(u, v), device=dev))
        torch.cuda.synchronize()
        stream_s = time.perf_counter() - t0
        assert autotune.last_report()["chosen"] == chosen
        assert stats["async_engine"] is cand.async_engine
        want, _ = rt.compress_tiled(u, v, tuned, tuned.tiling, device=dev)
        assert blob == want, f"{tag}: stream bytes != compress_tiled's"
        (ur, vr), dec = counted(fns, lambda: rt.decompress(blob, device=dev))
        check_path_launches(tag, tuned.codec,
                            {n: counts[n] + dec[n] for n in counts})
        check_guarantees(tag, u, v, ur, vr, stats, dev)
        say(f"{tag}: tune_stream chose {chosen} (async "
            f"{cand.async_engine}); compress_stream(autotune=True) "
            f"{stream_s:.3f} s host clock, bytes == compress_tiled of the "
            f"chosen plan ({len(blob)} B, ratio {stats['ratio']:.4f}, "
            f"{stats['n_units']} units); launches {json.dumps(counts)}")

    T, H, W = SIZES["main"][0]
    u, v = synthetic.vortex_street(T=T, H=H, W=W)
    cfg = rt.CompressionConfig(**scf_meta(T, H, W))
    uni = next(r for r in main if r["shape"] == (T, H, W)
               and r["codec"] == "host")
    target = SIZES["rate_factor"] * uni["ratio"]
    tag = f"rate {T}x{H}x{W}"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (blob, stats), enc = counted(fns, lambda: rt.compress(
        u, v, cfg, target_ratio=target, device=dev))
    rate_s = time.perf_counter() - t0
    rec = stats["rate_target"]
    (ur, vr), dec = counted(fns, lambda: rt.decompress(blob, device=dev))
    check_path_launches(tag, cfg.codec, {n: enc[n] + dec[n] for n in enc})
    header = encode.unpack(blob)[0]
    bound = None
    if "eb_policy" in header:
        pol = ebpolicy.policy_from_spec(header["eb_policy"])
        bound = ebpolicy.field_bounds(pol, u.shape,
                                      compressor._eb_factor(u, v, cfg))
    check_guarantees(tag, u, v, ur, vr, stats, dev, bound)
    say(f"{tag}: target {target:.4f} ({SIZES['rate_factor']} x the uniform "
        f"{uni['ratio']:.4f}): reached {rec['achieved_ratio']:.4f}, met "
        f"{rec['met']}, relax {rec['relax']}, seed relax "
        f"{rec.get('seed_relax')}, rungs {rec.get('rungs_tried')}, "
        f"protected {rec['n_protected']} of {rec.get('n_units')} units; "
        f"{rate_s:.3f} s host clock (one call: uniform run, probe, "
        f"tracks, rungs); launches {json.dumps(enc)}")

    scale = fixedpoint.to_fixed(u, v)[0]
    for name, fn in baselines.REGISTRY.items():
        out, counts = counted(fns, lambda: fn(u, v, eb=1e-2, device=dev))
        fc = trajectory.false_cases(u, v, out["u_rec"], out["v_rec"], scale,
                                    dev)
        err = np.maximum(np.abs(out["u_rec"].astype(np.float64) - u),
                         np.abs(out["v_rec"].astype(np.float64) - v)).max()
        if name in ("sz3-like", "cpsz-like"):
            assert counts["lorenzo_residual"] > 0, f"{name}: K1 not launched"
        if name == "cpsz-like":
            assert counts["face_crossed"] > 0 and fc["FC_t"] == 0, \
                f"{name}: {counts['face_crossed']} face_crossed, {fc}"
        if out["lossless"]:
            assert err == 0 and fc["FC_t"] == fc["FC_s"] == 0
        say(f"baseline {name} {T}x{H}x{W}: ratio {out['ratio']:.4f} "
            f"({out['comp_bytes']} B), compress {out['t_compress']:.4f} s, "
            f"decompress {out['t_decompress']:.4f} s, max err {float(err)!r} "
            f"(eb_abs {out.get('eb_abs', 0.0)!r}), FC_t {fc['FC_t']} FC_s "
            f"{fc['FC_s']} (CP_t {fc['CP_t_orig']}, CP_slab "
            f"{fc['CP_slab_orig']}); launches "
            f"{json.dumps({k: n for k, n in counts.items() if n})}")
    say(f"baseline ours {T}x{H}x{W} (host codec, phase 4): ratio "
        f"{uni['ratio']:.4f}, encode {uni['enc_s']:.3f} s, decode "
        f"{uni['dec_s']:.3f} s, FC_t 0 FC_s 0")
    say(f"autotune phase: {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------------
# phase 4i: LM serving
# ----------------------------------------------------------------------

def lm_inputs(cfg, rng, B, S, n):
    """A numpy prefill batch and ``n`` decode-step batches for ``cfg``."""
    if cfg.is_encoder_decoder:
        batch = {"frames": rng.normal(0, 1, (B, S, cfg.d_model))
                 .astype(np.float32),
                 "tokens": rng.integers(0, cfg.vocab, (B, 8))
                 .astype(np.int32)}
    elif cfg.embedding_inputs:
        batch = {"embeds": rng.normal(0, 1, (B, S, cfg.d_model))
                 .astype(np.float32),
                 "position_ids": np.broadcast_to(
                     np.arange(S, dtype=np.int32)[None, None],
                     (3, B, S)).copy()}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab, (B, S))
                 .astype(np.int32)}
    if cfg.embedding_inputs:
        steps = [{"embeds": rng.normal(0, 1, (B, 1, cfg.d_model))
                  .astype(np.float32)} for _ in range(n)]
    else:
        steps = [{"tokens": rng.integers(0, cfg.vocab, (B, 1))
                  .astype(np.int32)} for _ in range(n)]
    return batch, steps


def lm_drive(model, batch, steps, max_len, cache_dtype):
    """Prefill, pad the cache, decode ``steps``: every logits tensor and
    the final cache, as f64 numpy (int8 caches stay integral)."""
    from repro_torch.launch import serve

    dev = model.device
    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    logits, cache = model.prefill(tb)
    out = {"prefill": logits}
    kw = {"enc_len": batch["frames"].shape[1]} if "frames" in batch else {}
    if cache_dtype is not None:
        kw["dtype"] = cache_dtype
    n = (batch["tokens"] if "tokens" in batch else batch["embeds"]).shape[0]
    cache = serve.pad_cache(model, cache, n, max_len, **kw)
    for i, st in enumerate(steps):
        logits, cache = model.decode_step(
            {k: torch.from_numpy(v).to(dev) for k, v in st.items()}, cache)
        out[f"decode{i}"] = logits
    out.update({f"cache_{k}": v for k, v in cache.items()})
    return {k: v.detach().cpu().to(torch.float64).numpy()
            for k, v in out.items()}


def lm_err(ref, got, rel):
    """Max abs error of ``got`` and its bound: ``LM_F32_TOL`` + the f32
    relative part, or ``rel`` * max(1, max |ref|)."""
    err = float(np.abs(ref - got).max()) if ref.size else 0.0
    if rel is None:
        bound = float((LM_F32_TOL + LM_F32_TOL * np.abs(ref)).max()) \
            if ref.size else 0.0
        ok = ref.size == 0 or bool(np.all(np.abs(ref - got) <= LM_F32_TOL
                                          + LM_F32_TOL * np.abs(ref)))
    else:
        bound = rel * max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
        ok = err <= bound
    return err, bound, ok


def serve_parity(dev):
    """Card == CPU for every SMOKE architecture, f32 and bf16, and the
    int8 / head-padded cache of qwen1.5-32b."""
    import repro_torch.configs as C
    from repro_torch.models.transformer import build_model

    B, S, n = SIZES["serve_parity"]
    cases = [(a, d, None, {}) for d in ("float32", "bfloat16")
             for a in C.ARCHS]
    cases += [("qwen1_5_32b", d, "int8", {"decode_head_pad": 8})
              for d in ("float32", "bfloat16")]
    t0 = time.perf_counter()
    for arch, dtype, cache_dtype, override in cases:
        cfg = dataclasses.replace(C.get(arch).SMOKE, dtype=dtype, **override)
        cpu = build_model(cfg, device="cpu", seed=0)
        card = build_model(cfg, device="cpu", seed=0).to(dev)
        batch, steps = lm_inputs(cfg, np.random.default_rng(1), B, S, n)
        max_len = (8 if cfg.is_encoder_decoder else S) + n
        ref = lm_drive(cpu, batch, steps, max_len, cache_dtype)
        got = lm_drive(card, batch, steps, max_len, cache_dtype)
        rel = None if dtype == "float32" else LM_BF16_REL
        worst = {"logits": 0.0, "cache": 0.0}
        for key, r in ref.items():
            if key.startswith("cache_") and cache_dtype == "int8" \
                    and key in ("cache_k", "cache_v"):
                err = float(np.abs(r - got[key]).max())
                assert err <= 1, (arch, dtype, key, err)
                assert not got[key][:, :, :, cfg.n_kv_heads:].any()
            else:
                err, bound, ok = lm_err(r, got[key], rel)
                assert ok, (arch, dtype, key, err, bound)
            part = "cache" if key.startswith("cache_") else "logits"
            worst[part] = max(worst[part], err)
        tag = arch + (f" int8 pad {cfg.decode_head_pad}" if cache_dtype
                      else "")
        say(f"serve parity {tag} {dtype}: card == CPU, max |err| logits "
            f"{worst['logits']:.3e}, cache {worst['cache']:.3e} "
            f"({'rtol=atol=2e-4' if rel is None else f'<= {rel} x max'})")
    say(f"serve parity: {len(cases)} cases in "
        f"{time.perf_counter() - t0:.1f} s")


def phase_serve(dev):
    """The LM scaffold's serving path: card == CPU at SMOKE, then yi-6b at
    full published width through the launcher."""
    import repro_torch.configs as C
    from repro_torch.launch import serve
    from repro_torch.models.transformer import build_model

    assert torch.backends.cuda.matmul.allow_tf32 is False
    t_phase = time.perf_counter()
    serve_parity(dev)
    assert torch.backends.cuda.matmul.allow_tf32 is False

    arch = SIZES["serve_arch"]
    cfg = C.get(arch).CONFIG
    args = serve.parse_args(["--arch", arch, "--device", str(dev)])
    fns = wrappers()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=args.seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    reset_counts(fns)
    out = serve.run(args, model=model)
    counts = read_counts(fns)
    assert not any(counts.values()), counts   # no kernel on this path
    peak = torch.cuda.max_memory_allocated() - held
    assert out["prefills"] == args.requests
    assert out["decoded_tokens"] == args.requests * args.gen_len
    toks = np.stack([out["tokens"][r] for r in range(args.requests)])
    assert toks.shape == (args.requests, args.gen_len)
    assert ((toks >= 0) & (toks < cfg.vocab)).all()
    tok_s = out["decoded_tokens"] / out["decode_seconds"]
    # least time of a batch-1 decode step: read every bf16 weight once
    # (the embedding table only by its one gathered row)
    read = 2 * (n_params - cfg.vocab * cfg.d_model)
    bound_s = read / HBM_BYTES_PER_S
    say(f"serve {arch} full width ({n_params / 1e9:.3f} B params, "
        f"{cfg.dtype} activations, {cfg.param_dtype} weights + held "
        f"{cfg.dtype} copies): init {init_s:.2f} s; {out['requests']} "
        f"requests, batch {args.batch}, prompt {args.prompt_len}, gen "
        f"{args.gen_len}: {out['prefills']} prefills, "
        f"{out['decoded_tokens']} tokens in {out['seconds']:.3f} s, prefill "
        f"{out['prefill_seconds']:.3f} s, decode {tok_s:.1f} tokens/s "
        f"(bound {1.0 / bound_s:.1f}: {read / 1e9:.2f} GB of bf16 weights "
        f"a step at {HBM_BYTES_PER_S / 1e12:.2f} TB/s = "
        f"{bound_s * 1e3:.3f} ms), peak {peak / 2**20:.1f} MiB above the "
        f"held, compression kernels launched: 0")

    # one decode step under the profiler (a fresh request, warmed up)
    dev_t = model.device
    prompt = out["prompts"][0]["tokens"].to(dev_t)
    _, cache = model.prefill({"tokens": prompt})
    cache = serve.pad_cache(model, cache, 1, args.max_len)
    nxt = torch.zeros((1, 1), dtype=torch.int32, device=dev_t)
    model.decode_step({"tokens": nxt}, cache)
    wall, busy, rows = device_profile(
        lambda: model.decode_step({"tokens": nxt}, cache))
    say(f"serve {arch} one decode step profiled: wall {wall * 1e3:.3f} ms, "
        f"device {busy * 1e3:.3f} ms, busy {100 * busy / wall:.1f} %, "
        f"{sum(r[2] for r in rows)} device ops; top "
        + ", ".join(f"{n[:40]} {ms:.3f} ms x{c}" for n, ms, c in rows[:4]))

    # the last decode step's logits == one prefill over the whole sequence
    seq = torch.cat([out["prompts"][0]["tokens"],
                     torch.from_numpy(out["tokens"][0])[None]], dim=1)
    full, _ = model.prefill({"tokens": seq.to(dev_t)})
    ref = full.double().cpu().numpy()
    got = out["last_logits"][0].double().cpu().numpy()
    err, bound, ok = lm_err(ref, got, LM_BF16_REL)
    same_top = int(ref.argmax()) == int(got.argmax())
    say(f"serve {arch} decode vs prefill over {seq.shape[1]} tokens: max "
        f"|err| {err:.3e} (bound {bound:.4f}, max |logit| "
        f"{float(np.abs(ref).max()):.3f}), {int((ref != got).sum())} of "
        f"{ref.size} logits differ, same argmax {same_top}")
    assert ok, (err, bound)
    del model, cache, full
    torch.cuda.empty_cache()
    say(f"serve: phase {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------------
# phase 4j: LM training
# ----------------------------------------------------------------------

TRAIN_OPT = dict(lr=1e-3, warmup_steps=20)   # launch/train.py's AdamW


def train_drive(model, batches, microbatches=1):
    """``len(batches)`` steps of ``make_train_step`` from ``model``'s
    parameters: the losses, every gradient leaf of the first step (mb 1)
    and the parameters, m and v after the last, as f64 numpy."""
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    cfg = model.cfg
    ocfg = opt.AdamWConfig(**TRAIN_OPT, state_dtype=cfg.opt_state_dtype)
    step = ts.make_train_step(model, ocfg, microbatches)
    state = ts.init_train_state(model, ocfg)
    named = dict(model.named_parameters())
    out = {}
    if microbatches == 1:
        _, _, grads = ts.value_and_grad(model, named, batches[0])
        out.update({f"grad {n}": g for n, g in grads.items()})
    losses = []
    for b in batches:
        state, met = step(state, b)
        losses.append(met["loss"])
    out["loss"] = torch.stack(losses)
    out.update({f"param {n}": p.detach() for n, p in named.items()})
    for key in ("m", "v"):
        out.update({f"{key} {n}": t for n, t in state["adam"][key].items()})
    return {k: v.detach().cpu().to(torch.float64).numpy()
            for k, v in out.items()}, state


def train_batches(cfg, dev, B, S, n):
    from repro_torch.data.tokens import TokenPipelineConfig
    from repro_torch.launch import train

    tp = TokenPipelineConfig(vocab=cfg.vocab, batch=B, seq_len=S)
    return [train.make_batch(cfg, tp, i, B, S, dev) for i in range(n)]


def train_err(ref, got, key, rel, lr_sum):
    """(max |err|, bound, ok) of one train_drive entry: f32 within
    LM_F32_TOL + LM_F32_TOL |ref| (parameters: + 2 * the summed lr, an
    Adam update of a near-zero gradient can go either way), bf16 within
    ``rel`` * max(1, max |ref|)."""
    if rel is not None:
        return lm_err(ref, got, rel)
    slack = 2 * lr_sum if key.startswith("param ") else 0.0
    tol = LM_F32_TOL + slack + LM_F32_TOL * np.abs(ref)
    err = float(np.abs(ref - got).max()) if ref.size else 0.0
    return err, float(tol.max()) if ref.size else 0.0, \
        bool(np.all(np.abs(ref - got) <= tol))


def train_parity(dev):
    """Card == CPU for two training steps of every SMOKE architecture (f32
    activations, TF32 off) and one bf16 run a family; micro-batches 2
    against 1 on the card; compress_grads on the card == on the CPU bit
    for bit; a checkpoint saved from the card restores on the CPU bit
    for bit."""
    import tempfile

    import repro_torch.configs as C
    from repro_torch.launch import train
    from repro_torch.models.transformer import build_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import grad_compress as gc
    from repro_torch.train import train_step as ts

    B, S, n = SIZES["train_parity"]
    lr_sum = sum(TRAIN_OPT["lr"] * min((i + 1) / TRAIN_OPT["warmup_steps"],
                                       1.0) for i in range(n))
    families = {}
    for a in C.ARCHS:
        families.setdefault(C.get(a).SMOKE.family, a)
    cases = [(a, "float32") for a in C.ARCHS] \
        + [(a, "bfloat16") for a in families.values()]
    t0 = time.perf_counter()
    for arch, dtype in cases:
        cfg = dataclasses.replace(C.get(arch).SMOKE, dtype=dtype)
        cpu = build_model(cfg, device="cpu", seed=0)
        card = build_model(cfg, device="cpu", seed=0).to(dev)
        ref, _ = train_drive(cpu, train_batches(cfg, "cpu", B, S, n))
        got, _ = train_drive(card, train_batches(cfg, dev, B, S, n))
        rel = None if dtype == "float32" else LM_BF16_REL
        worst = {}
        for key, r in ref.items():
            err, bound, ok = train_err(r, got[key], key, rel, lr_sum)
            assert ok, (arch, dtype, key, err, bound)
            part = key.split(" ")[0]
            worst[part] = max(worst.get(part, 0.0), err)
        say(f"train parity {arch} {dtype}: card == CPU over {n} steps, max "
            f"|err| " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
            + f" (losses {', '.join(f'{x:.5f}' for x in got['loss'])})")

    # micro-batches 2 against 1, and compression and a checkpoint of the
    # card's state
    cfg = C.get("qwen2_vl_7b").SMOKE
    cfg = dataclasses.replace(cfg, dtype="float32")
    batches = train_batches(cfg, dev, B, S, n)
    one, _ = train_drive(build_model(cfg, device="cpu", seed=0).to(dev),
                         batches)
    model = build_model(cfg, device="cpu", seed=0).to(dev)
    two, state = train_drive(model, batches, microbatches=2)
    worst = 0.0
    for key, r in two.items():
        err, bound, ok = train_err(one[key], r, key, None, lr_sum)
        assert ok, ("microbatches", key, err, bound)
        worst = max(worst, err)
    say(f"train parity {cfg.name} microbatches 2 vs 1 on the card "
        f"((3, B, S) position_ids split on axis 1): max |err| {worst:.3e}")

    named = dict(model.named_parameters())
    _, _, grads = ts.value_and_grad(model, named, batches[0])
    gcfg = gc.GradCompressConfig(enabled=True)
    res_d, res_h = gc.init_residuals(grads), gc.init_residuals(
        {k: g.cpu() for k, g in grads.items()})
    for r in range(3):
        g_d = {k: g * 10.0 ** (r - 1) for k, g in grads.items()}
        out_d, res_d, _ = gc.compress_grads(g_d, res_d, gcfg)
        out_h, res_h, _ = gc.compress_grads(
            {k: g.cpu() for k, g in g_d.items()}, res_h, gcfg)
        for k in out_h:
            assert torch.equal(out_d[k].cpu(), out_h[k]), ("gc grad", r, k)
            assert torch.equal(res_d[k].cpu(), res_h[k]), ("gc res", r, k)
    say(f"train parity compress_grads: card == CPU bitwise over 3 rounds "
        f"of error feedback ({len(grads)} leaves)")

    trees = train.checkpoint_trees(cfg, model, state)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        ckpt.save(tmp, 2, trees)
        restored, _ = ckpt.restore(tmp, trees)
    n_leaves = 0
    for path, leaf in ckpt._leaves(trees):
        node = restored
        for p in path:
            node = node[p]
        want = leaf.numpy()
        assert node.dtype == want.dtype and np.array_equal(node, want), path
        n_leaves += 1
    say(f"train parity checkpoint: saved from the card, restored on the "
        f"CPU bitwise ({n_leaves} leaves)")
    say(f"train parity: {len(cases)} cases in "
        f"{time.perf_counter() - t0:.1f} s")


def phase_train(dev):
    """The LM scaffold's training path (repro_torch.launch.train; no
    kernel of this package lies on it): card == CPU at SMOKE, then
    stablelm-1.6b at full published width through the launcher."""
    import statistics

    import repro_torch.configs as C
    from repro_torch.launch import train
    from repro_torch.models.transformer import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    assert torch.backends.cuda.matmul.allow_tf32 is False
    t_phase = time.perf_counter()
    train_parity(dev)

    arch = SIZES["train_arch"]
    cfg = C.get(arch).CONFIG
    args = train.parse_args(["--arch", arch, "--steps",
                             str(SIZES["train_steps"]), "--log-every", "1",
                             "--device", str(dev)])
    fns = wrappers()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=args.seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    reset_counts(fns)
    out = train.run(args, model=model)
    counts = read_counts(fns)
    assert not any(counts.values()), counts   # no kernel on this path
    peak = torch.cuda.max_memory_allocated() - held
    losses = out["losses"]
    assert len(losses) == args.steps and np.isfinite(losses).all(), losses
    ln_v = float(np.log(cfg.vocab))
    assert abs(losses[0] - ln_v) < 2.0, (losses[0], ln_v)
    tokens = args.batch * args.seq
    step_s = statistics.median(out["seconds"][1:])
    # least time of a step: the matmuls of forward, recomputed forward and
    # backward (8 flops a weight and token; the embedding table is only
    # gathered) at the bf16 peak, then AdamW's read of p, g, m, v and
    # write of p, m, v (28 B a parameter, f32) at the HBM rate
    flops = 8.0 * (n_params - cfg.vocab * cfg.d_model) * tokens
    opt_bytes = 28.0 * n_params
    t_flops, t_bytes = flops / BF16_FLOPS, opt_bytes / HBM_BYTES_PER_S
    bound_s = t_flops + t_bytes
    say(f"train {arch} full width ({n_params / 1e9:.3f} B params, "
        f"{cfg.dtype} activations, {cfg.param_dtype} parameters and "
        f"moments): init {init_s:.2f} s; {args.steps} steps of batch "
        f"{args.batch} x seq {args.seq} ({tokens} tokens): losses "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f" (ln V = {ln_v:.4f}); step seconds "
        + ", ".join(f"{x:.4f}" for x in out["seconds"])
        + f"; median of steps 2-{args.steps} {step_s:.4f} s = "
        f"{tokens / step_s:.1f} tokens/s; bound {bound_s * 1e3:.3f} ms "
        f"({flops / 1e12:.2f} TFLOP at {BF16_FLOPS / 1e12:.0f} TFLOP/s = "
        f"{t_flops * 1e3:.3f} ms + {opt_bytes / 1e9:.2f} GB at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s = {t_bytes * 1e3:.3f} ms); peak "
        f"{peak / 2**20:.1f} MiB above the held; {out['stragglers']} "
        f"straggler events; compression kernels launched: 0")

    # one more step under the profiler
    batch = train.make_batch(cfg, out["tp_cfg"], args.steps, args.batch,
                             args.seq, dev)
    box = {"state": out["state"]}

    def one_step():
        box["state"], met = out["step_fn"](box["state"], batch)
        box["loss"] = met["loss"]

    wall, busy, rows = device_profile(one_step)
    assert np.isfinite(float(box["loss"]))
    say(f"train {arch} one step profiled: wall {wall * 1e3:.3f} ms, device "
        f"{busy * 1e3:.3f} ms, busy {100 * busy / wall:.1f} %, "
        f"{sum(r[2] for r in rows)} device ops; bound "
        f"{bound_s * 1e3:.3f} ms; top "
        + ", ".join(f"{n[:40]} {ms:.3f} ms x{c}" for n, ms, c in rows[:5]))

    # the step's two halves apart: loss + backward, then AdamW alone
    named = dict(model.named_parameters())
    ocfg = opt.AdamWConfig(lr=args.lr, warmup_steps=20,
                           state_dtype=cfg.opt_state_dtype)
    box.update(grads=None)

    def backward():
        box["grads"] = ts.value_and_grad(model, named, batch)[2]

    def adamw():
        opt.apply_updates(named, box["grads"], box["state"]["adam"], ocfg)

    for tag, fn, floor in (("loss + backward", backward, t_flops),
                           ("AdamW", adamw, t_bytes)):
        wall, busy, rows = device_profile(fn)
        say(f"train {arch} {tag} profiled: wall {wall * 1e3:.3f} ms, device "
            f"{busy * 1e3:.3f} ms, {sum(r[2] for r in rows)} device ops; "
            f"its bound {floor * 1e3:.3f} ms")
    del model, out, box, batch, named
    torch.cuda.empty_cache()
    say(f"train: phase {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------------
# phase 4k: the dry run and the cost model
# ----------------------------------------------------------------------

def dry_cost(model_fn, cell, dev, warm=False):
    """(OpCost, FlopCounterMode's total, memory report) of one step of
    ``cell`` on the model ``model_fn()`` builds; ``warm`` runs a step
    once before the counted call (the real step's cuBLAS handles and
    workspaces), then makes the counted step anew, so that its arguments
    are the tensors it reads (a decode step gives its cache a new
    length tensor)."""
    from repro_torch import roofline
    from repro_torch.launch import dryrun

    model = model_fn()
    fn, args = dryrun.make_step(model, cell, dev)
    if warm:
        fn()
        torch.cuda.synchronize()
        del fn, args
        fn, args = dryrun.make_step(model, cell, dev)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cost, raw, out = dryrun.trace(fn)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    outs = dryrun._tensors(out)
    mem = roofline.memory_report(cost, args, outs)
    mem["workload"] = roofline.workload_bytes(cost, args, outs)
    return cost, raw, mem, peak, (model, fn)


def held_step(dev, arch, cell, what):
    """The fake trace and the real step under CostMode of one full-width
    step: equal flops, bytes and ops; the predicted peak against the
    card's; the roofline time beside the profiled step."""
    import repro_torch.configs as C
    from repro_torch import roofline
    from repro_torch.launch import dryrun
    from repro_torch.models.transformer import build_model

    cfg = C.get(arch).CONFIG
    t0 = time.perf_counter()
    with dryrun.fake_tensors():
        fake, fraw, fmem, _, _ = dry_cost(
            lambda: build_model(cfg, device=dev), cell, dev)
    fake_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    real, rraw, rmem, peak, (model, fn) = dry_cost(
        lambda: build_model(cfg, device=dev, seed=0), cell, dev, warm=True)
    real_s = time.perf_counter() - t0
    diff = {k: (fake.op_counts[k], real.op_counts[k])
            for k in set(fake.op_counts) | set(real.op_counts)
            if fake.op_counts[k] != real.op_counts[k]}
    n_ops = sum(real.op_counts.values())
    say(f"dryrun {arch} {what}: fake trace {fake_s:.1f} s, real step under "
        f"CostMode {real_s:.1f} s (build included); flops {fake.flops:.6e} "
        f"/ {real.flops:.6e}, eager bytes {fake.eager_bytes:.6e} / "
        f"{real.eager_bytes:.6e}, workload bytes {fmem['workload']:.6e} / "
        f"{rmem['workload']:.6e}, "
        f"{sum(fake.op_counts.values())} / {n_ops} ops (fake / real); "
        f"ops that differ {diff}")
    assert not diff, diff
    assert (fake.flops, fake.eager_bytes, fake.dot_flops) == \
        (real.flops, real.eager_bytes, real.dot_flops)
    assert fake.peak_bytes == real.peak_bytes and fmem == rmem
    assert fraw == rraw
    pred = real.peak_bytes
    rel = abs(pred - peak) / peak
    say(f"dryrun {arch} {what}: predicted peak {pred / 2**20:.1f} MiB "
        f"(resident {fmem['resident_bytes'] / 2**30:.3f} GiB = arguments "
        f"{fmem['argument_size_in_bytes'] / 2**30:.3f} GiB + the call's "
        f"peak), card {peak / 2**20:.1f} MiB above the held "
        f"(torch.cuda.max_memory_allocated), {100 * rel:.2f} % apart; "
        f"alias {fmem['alias_size_in_bytes'] / 2**30:.3f} GiB")
    assert rel <= DRYRUN_PEAK_REL, (pred, peak)
    workload = fmem.pop("workload")
    rl = roofline.analyze(fake, fmem, fraw, cfg.name, what, "card", 1, cfg,
                          cell, workload)
    t_roof = max(rl.t_compute, rl.t_memory)
    t_work = max(rl.t_compute, rl.t_memory_workload)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    p_wall, busy, rows = device_profile(fn)
    say(f"dryrun {arch} {what}: roofline {t_roof * 1e3:.3f} ms "
        f"({rl.bottleneck}: compute {rl.t_compute * 1e3:.3f} ms = "
        f"{fake.flops / 1e12:.4f} TFLOP ({fake.dot_flops / 1e12:.4f} in "
        f"dots) at {roofline.PEAK_FLOPS / 1e12:.0f} TFLOP/s, memory "
        f"{rl.t_memory * 1e3:.3f} ms = {fake.eager_bytes / 1e9:.3f} GB at "
        f"{roofline.HBM_BW / 1e12:.2f} TB/s of eager bytes); workload "
        f"roofline {t_work * 1e3:.3f} ms ({rl.workload_bottleneck}: memory "
        f"{rl.t_memory_workload * 1e3:.3f} ms = {workload / 1e9:.3f} GB "
        f"the step must move); step {wall_s * 1e3:.3f} ms "
        f"wall; profiled {p_wall * 1e3:.3f} ms wall, {busy * 1e3:.3f} ms "
        f"device ({sum(r[2] for r in rows)} device ops), device "
        f"{busy / t_roof:.2f}x the eager roofline, {busy / t_work:.2f}x the "
        f"workload roofline; FlopCounterMode "
        f"{fraw / 1e12:.4f} TFLOP; nondot "
        + ", ".join(f"{k} {v:.3e}" for k, v in sorted(
            fake.nondot_flops.items())))
    del model, fn
    torch.cuda.empty_cache()
    return fake


def phase_dryrun(dev):
    """The dry run (repro_torch.launch.dryrun; no kernel of this package
    lies on it): cells of the card mesh traced on fake CUDA tensors, then
    the cost model held against two full-width steps on the card."""
    import repro_torch.configs as C
    from repro_torch.configs import CellSpec
    from repro_torch.launch import dryrun

    t_phase = time.perf_counter()
    fns = wrappers()
    reset_counts(fns)
    n_ok = 0
    for arch, shape in SIZES["dryrun_cells"]:
        row = dryrun.lower_cell(C.get(arch), shape, dryrun.card_mesh(),
                                "card", dev)
        if row["status"] == "skip":
            say(f"dryrun {arch} {shape}: skip ({row['reason'][:60]})")
            continue
        assert row["status"] == "ok", row
        mem = row["memory"]
        say(f"dryrun {arch} {shape} card: trace {row['trace_s']} s, "
            f"flops/dev {row['hlo_flops_raw']:.4e}, eager bytes/dev "
            f"{row['eager_bytes_per_device']:.4e}, workload bytes/dev "
            f"{row['workload_bytes_per_device']:.4e}, resident "
            f"{mem['resident_bytes'] / 2**30:.2f} GiB, bottleneck "
            f"{row['bottleneck']} (workload: {row['workload_bottleneck']}), "
            f"t_compute {row['t_compute_s']:.4e} s, t_memory "
            f"{row['t_memory_s']:.4e} s (workload "
            f"{row['t_memory_workload_s']:.4e} s), model/hlo flops "
            f"{row['useful_flops_ratio']:.4f}")
        n_ok += 1
    assert n_ok, "no dry-run cell ran"

    arch, B, S = SIZES["dryrun_train"]
    train = held_step(dev, arch, CellSpec("train", S, B), f"train {B}x{S}")
    ratio = train.dot_flops / (STABLELM_STEP_TFLOP * 1e12)
    say(f"dryrun {arch} train {B}x{S}: dot flops "
        f"{train.dot_flops / 1e12:.4f} TFLOP, {ratio:.4f}x the hand count "
        f"{STABLELM_STEP_TFLOP} TFLOP (8 flops a matmul weight and token), "
        f"band {STABLELM_DOT_BAND}")
    assert STABLELM_DOT_BAND[0] <= ratio <= STABLELM_DOT_BAND[1], ratio
    arch, slots, max_len = SIZES["dryrun_decode"]
    held_step(dev, arch, CellSpec("decode", max_len, slots,
                                  cache_len=max_len),
              f"decode {slots} slots max-len {max_len}")
    counts = read_counts(fns)
    assert not any(counts.values()), counts   # no kernel on this path
    say(f"dryrun: {n_ok} cells, phase {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------------
# phase 4l: sharded execution
# ----------------------------------------------------------------------

def shard_rank(rank, world, port, out_path, archs, shape):
    """One NCCL rank of the sharded steps (``--shard-steps``): two train
    steps of each of ``archs`` (SMOKE, f32) with every parameter a
    DTensor on a ``shape`` ("data", "model") mesh, and, on rank 0, the
    same steps on one card without DTensor; rank 0 writes the losses,
    the largest errors and the step times to ``out_path``."""
    import torch.distributed as dist

    import repro_torch.configs as C
    from repro_torch.launch import train
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.transformer import build_model
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", rank=rank, world_size=world,
                            device_id=dev)
    fns = wrappers()
    reset_counts(fns)
    m = Mesh(shape, ("data", "model"))
    mesh = m.device_mesh("cuda")
    rules = shd.rules_for_mesh(m)
    B, S, n = SIZES["shard_steps"]
    lr_sum = sum(TRAIN_OPT["lr"] * min((i + 1) / TRAIN_OPT["warmup_steps"],
                                       1.0) for i in range(n))
    rows = []
    for arch in archs:
        cfg = dataclasses.replace(C.get(arch).SMOKE, dtype="float32")
        ocfg = opt.AdamWConfig(**TRAIN_OPT, state_dtype=cfg.opt_state_dtype)
        batches = train_batches(cfg, dev, B, S, n)

        def steps(model, sharded):
            step = ts.make_train_step(model, ocfg)
            state = ts.init_train_state(model, ocfg)
            losses, norms, times = [], [], []
            with shd.use_rules(rules if sharded else None):
                for b in batches:
                    if sharded:
                        b = train.place_batch(b, mesh, rules)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, met = step(state, b)
                    losses.append(float(met["loss"]))
                    norms.append(float(met["grad_norm"]))
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
            return losses, norms, times

        model = build_model(cfg, device="cpu", seed=0).to(dev)
        shd.distribute_params(model, mesh, rules)
        losses, norms, times = steps(model, True)
        params = {k: p.detach().full_tensor()
                  for k, p in model.named_parameters()}
        placed = sum(any(q.is_shard() for q in p.placements)
                     for p in model.parameters())
        if rank == 0:
            one = build_model(cfg, device="cpu", seed=0).to(dev)
            ref_losses, ref_norms, ref_times = steps(one, False)
            err = max(abs(a - b) for a, b in zip(losses, ref_losses))
            assert err <= LM_F32_TOL + LM_F32_TOL * max(
                abs(x) for x in ref_losses), (arch, losses, ref_losses)
            # the global norm sets the clip factor, which AdamW's first
            # update hides from the parameters
            norm_err = max(abs(a - b) / b for a, b in zip(norms, ref_norms))
            assert norm_err <= SHARD_NORM_REL, (arch, norms, ref_norms)
            worst = 0.0
            for k, p in one.named_parameters():
                ref = p.detach().double()
                d = (params[k].double() - ref).abs()
                tol = LM_F32_TOL + 2 * lr_sum + LM_F32_TOL * ref.abs()
                assert bool((d <= tol).all()), (arch, k, float(d.max()))
                worst = max(worst, float(d.max()))
            rows.append({"arch": arch, "losses": losses,
                         "ref_losses": ref_losses, "loss_err": err,
                         "norm_err": norm_err,
                         "param_err": worst, "sharded_leaves": placed,
                         "step_s": times, "ref_step_s": ref_times})
        dist.barrier()
    counts = read_counts(fns)
    assert not any(counts.values()), counts   # no kernel on this path
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump({"world": world, "mesh": list(shape), "rows": rows}, f)
    dist.destroy_process_group()


def shard_steps_child(out_path: str) -> int:
    """``--shard-steps``: the sharded steps on every card of the machine
    (an even count, at most 8), or an NCCL world of one on one card."""
    import socket

    import repro_torch.configs as C

    n = min(torch.cuda.device_count(), 8)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    if n == 1:
        shard_rank(0, 1, port, out_path, list(C.ARCHS), (1, 1))
        return 0
    import torch.multiprocessing as mp

    n -= n % 2
    mp.spawn(shard_rank, args=(n, port, out_path,
                               list(SIZES["shard_multi_archs"]),
                               (n // 2, 2)), nprocs=n)
    return 0


def start_child(cmd):
    """A child process in a session of its own (its own children -- the
    NCCL ranks of ``--shard-steps`` -- stop with it in ``stop_child``)."""
    return subprocess.Popen(cmd, env=child_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def stop_child(proc):
    """Kill ``proc``'s session if it is still running."""
    if proc.poll() is None:
        import signal

        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def child_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    return env


def phase_shard(dev):
    """Sharded execution (module docstring, 4l): real steps over NCCL, then
    the dry run's production meshes on a fake process group (the three
    cells' children at once), each in a child process."""
    t_phase = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    out_path = ROOT / "build" / "shard_steps.json"
    t0 = time.perf_counter()
    proc = start_child([sys.executable, str(ROOT / "chip_smoke.py"),
                        "--shard-steps", str(out_path)])
    try:
        out, _ = proc.communicate(timeout=SHARD_CHILD_TIMEOUT_S)
    finally:
        stop_child(proc)
    steps_s = time.perf_counter() - t0
    assert proc.returncode == 0, out[-6000:]
    with open(out_path) as f:
        steps = json.load(f)
    world = steps["world"]
    if world == 1:
        say("shard steps: one card -- an NCCL world of one on a (1, 1) "
            "mesh, every parameter a DTensor, against the same card "
            "without DTensor; multi-rank execution is shown on CPU gloo "
            "ranks (tests/test_torch_sharded*.py), not here")
    else:
        say(f"shard steps: {world} cards -- {world} NCCL ranks on a "
            f"{tuple(steps['mesh'])} mesh against one card")
    for row in steps["rows"]:
        say(f"shard steps {row['arch']} world {world}: losses "
            + ", ".join(f"{x:.6f}" for x in row["losses"])
            + f" (one card {', '.join(f'{x:.6f}' for x in row['ref_losses'])}"
            f"), max |err| loss {row['loss_err']:.3e} params "
            f"{row['param_err']:.3e}, grad_norm rel {row['norm_err']:.3e}, "
            f"{row['sharded_leaves']} leaves "
            f"sharded; step s "
            + ", ".join(f"{x:.4f}" for x in row["step_s"])
            + f" (one card {', '.join(f'{x:.4f}' for x in row['ref_step_s'])})")
    say(f"shard steps: child {steps_s:.1f} s")

    cells = []
    for arch, shape, mesh in SIZES["shard_cells"]:
        path = ROOT / "build" / f"shard_{arch}_{shape}_{mesh}.json"
        cells.append(((arch, shape, mesh), path, start_child(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--device", "cuda",
             "--out", str(path)])))
    try:
        shard_cells(dev, cells)
    finally:
        for _, _, proc in cells:
            stop_child(proc)
    say(f"shard: phase {time.perf_counter() - t_phase:.1f} s")


def shard_cells(dev, cells):
    """Read the sharded dry-run children's rows (phase 4l (b))."""
    import repro_torch.configs as C
    from repro_torch.launch import dryrun
    from repro_torch.models.transformer import build_model

    mod = C.get("qwen1_5_0_5b")
    with dryrun.fake_tensors():
        fn, _ = dryrun.make_step(build_model(mod.CONFIG, device=dev),
                                 mod.CELLS["decode_32k"], dev)
        card = dryrun.trace(fn)[0]
    card_dots = card.dot_flops
    card_net = card.flops - card.copy_flops
    for (arch, shape, mesh), path, proc in cells:
        out, _ = proc.communicate(timeout=SHARD_CHILD_TIMEOUT_S)
        assert proc.returncode == 0 and "1 ok, 0 skip, 0 fail" in out, \
            out[-3000:]
        with open(path) as f:
            row, = json.load(f)
        mem = row["memory"]
        say(f"shard dryrun {arch} {shape} {mesh} ({row['chips']} fake "
            f"cards, cuda mesh): trace {row['trace_s']} s, flops/dev "
            f"{row['hlo_flops_raw']:.4e} (dots "
            f"{row['dot_flops_per_device']:.4e}), eager bytes/dev "
            f"{row['eager_bytes_per_device']:.4e}, workload bytes/dev "
            f"{row['workload_bytes_per_device']:.4e}, collective bytes/dev "
            f"{row['coll_bytes_per_device']:.4e} by kind "
            f"{json.dumps(row['coll_breakdown'])} by axis "
            f"{json.dumps(row['coll_by_axis'])} over "
            + ", ".join(f"{a} {v['link']} {v['bytes_per_s'] / 1e9:.0f} GB/s"
                        for a, v in row["axis_links"].items())
            + f", resident {mem['resident_bytes'] / 2**20:.1f} MiB, "
            f"t_compute {row['t_compute_s']:.4e} s, t_memory "
            f"{row['t_memory_s']:.4e} s (workload "
            f"{row['t_memory_workload_s']:.4e} s), t_collective "
            f"{row['t_collective_s']:.4e} s, bottleneck {row['bottleneck']} "
            f"(workload: {row['workload_bottleneck']})")
        assert row["coll_bytes_per_device"] > 0, row
        if (arch, shape) == ("qwen1_5_0_5b", "decode_32k"):
            # batch and heads divide both meshes: no dot is repeated
            total = row["dot_flops_per_device"] * row["chips"]
            say(f"shard dryrun {arch} {shape} {mesh}: dot flops/dev x "
                f"{row['chips']} = {total:.4e}, card mesh {card_dots:.4e} "
                f"({total / card_dots:.6f}x)")
            assert abs(total - card_dots) <= 0.01 * card_dots, \
                (total, card_dots)
            # every flop but eager's layout copies: replication only adds
            # (the card mesh's einsum copies the f32 K / V cache into
            # bmm's layout; a shard with one KV head needs no copy)
            net = (row["hlo_flops_raw"] - row["copy_flops_per_device"]) \
                * row["chips"]
            say(f"shard dryrun {arch} {shape} {mesh}: flops/dev x "
                f"{row['chips']} = {row['hlo_flops_raw'] * row['chips']:.4e}"
                f", card mesh {card.flops:.4e} "
                f"({row['hlo_flops_raw'] * row['chips'] / card.flops:.6f}x); "
                f"less copies {net:.4e} vs {card_net:.4e} "
                f"({net / card_net:.6f}x; card copies {card.copy_flops:.4e})")
            assert card_net <= net <= 1.03 * card_net, (net, card_net)


# ----------------------------------------------------------------------
# phase 5: the kernel table at the main path's shapes
# ----------------------------------------------------------------------

def sl_ops_count(xu, xv, g2f, cx, cy, d_max, n_max):
    """f64 operations of the SL stepper on these inputs (any stack)."""
    u = xu.to(torch.float64) * g2f
    v = xv.to(torch.float64) * g2f
    d_inf = torch.maximum(u.abs() * cx, v.abs() * cy)
    n_sub = torch.clamp(torch.ceil(d_inf / d_max), 1.0, float(n_max))
    rk = d_inf <= d_max
    # per pixel: 12 setup + final two bilinear samples (2 x 15) + 2
    # divisions; RK2: two bilinear samples + 8; substeps: 2 + per step
    # two bilinear samples + 6
    per = 44 + torch.where(rk, torch.full_like(n_sub, 38.0),
                           2.0 + 36.0 * n_sub)
    return float(per.sum())


def sl_branches(xu, xv, g2f, cx, cy, d_max, n_max) -> str:
    """Which branch the stepper takes on these pixels: the RK2 share and
    the substep counts of the others."""
    u = xu.to(torch.float64) * g2f
    v = xv.to(torch.float64) * g2f
    d_inf = torch.maximum(u.abs() * cx, v.abs() * cy)
    rk = d_inf <= d_max
    n_sub = torch.clamp(torch.ceil(d_inf[~rk] / d_max), 1.0, float(n_max))
    sub = (f"substeps mean {float(n_sub.mean()):.2f}, "
           f"max {float(n_sub.max()):g}" if n_sub.numel() else "no substeps")
    return f"RK2 {100 * float(rk.double().mean()):.2f} % of pixels, {sub}"


def decode_sl_pixels(args, out):
    """The frame t-1 values (xu, xv) of the pixels that sl_decode steps
    through SL on these inputs, as flat tensors; out is its result."""
    _, _, _, _, bm, flags, block = args[:7]
    T, H, W = out[0].shape
    mask = (bm.bool() & flags.bool()[:, None, None]) \
        .repeat_interleave(block, dim=1) \
        .repeat_interleave(block, dim=2)[:, :H, :W]
    return out[0][:-1][mask[1:]], out[1][:-1][mask[1:]]


def bound_terms(name, args, out):
    """(bytes, f64 operations) the function needs on these inputs: each
    input read once, each output written once."""
    if name == "lorenzo_residual":
        # ufp, vfp, k, lossless read; res_u, res_v (and xu, xv with
        # want_x) written
        ufp, want_x = args[0], args[6]
        return ufp.numel() * (16 + 4 + 1 + 16 + (16 if want_x else 0)), 0
    if name == "lorenzo_residual_units":
        # the extensions' ufp, vfp, k, lossless read and X written; the
        # owned boxes' residuals written
        ufp, owned = args[0], args[6]
        n_owned = ufp.shape[0] * owned[3] * owned[4] * owned[5]
        return ufp.numel() * (16 + 4 + 1 + 16) + n_owned * 16, 0
    if name == "face_crossed":
        # the faces' ids read and their bits written; the values of the
        # vertices they name read once
        u, verts = args[0], args[2]
        n_v = int(torch.unique(verts).numel())
        return verts.numel() * 8 + verts.shape[0] + n_v * 16, 0
    if name == "verify_faces_units":
        # verify_faces' terms summed over the units, the tables once
        st, sb = args[5], args[6]
        per = [bound_terms("verify_faces", unit_args(args, b), out_b)[0]
               - (st.numel() + sb.numel()) * 8
               for b, out_b in enumerate(unit_bad(args))]
        return sum(per) + (st.numel() + sb.numel()) * 8, 0
    if name == "sl_decode_units":
        bm, flags = args[4], args[5]
        ops = 0.0
        for b in range(args[0].shape[0]):
            xu, xv = decode_sl_pixels(
                tuple(a[b] for a in args[:6]) + args[6:],
                (out[0][b], out[1][b]))
            ops += sl_ops_count(xu, xv, *args[7:])
        return args[0].numel() * 32 + bm.numel() + flags.numel(), ops
    if name == "verify_faces":
        # screen: the four int64 vertex arrays; incremental: delta and
        # (ur, vr) at the vertices of the selected faces; both: the two
        # face tables once, the original predicate of each selected face
        # and the forced bytes of the bad faces' vertices (3 a bad face;
        # out is the plain version's count)
        ur, delta, st, sb = args[0], args[4], args[5], args[6]
        verts = selected_faces(args)
        if delta is None:
            fields = ur.numel() * 32
        else:
            fields = delta.numel() + int(torch.unique(verts).numel()) * 16
        return (fields + (st.numel() + sb.numel()) * 8 + verts.shape[0]
                + 3 * int(out)), 0
    if name == "symbol_histogram":
        # n uint8 read, 256 int32 written per row; the integer adds are
        # not counted (the card's peak table has no scalar integer rate)
        sym = args[0]
        return sym.numel() + sym.shape[0] * 256 * 4, 0
    if name == "sl_decode":
        # per pixel 16 B read (c2 or res) and 16 B written, plus the
        # blockmap and flags; the stepper's operations on the pixels of
        # the SL blocks only
        bm, flags = args[4], args[5]
        xu, xv = decode_sl_pixels(args, out)
        return (args[0].numel() * 32 + bm.numel() + flags.numel(),
                sl_ops_count(xu, xv, *args[7:]))
    # sl_step_batched: 16 B in, 16 B out per pixel
    return args[0].numel() * 32, sl_ops_count(*args)


def unit_args(args, b):
    """verify_faces_units' arguments -> verify_faces' of unit b."""
    return tuple(None if a is None else a[b] if i not in (5, 6) else a
                 for i, a in enumerate(args))


def unit_bad(args):
    """Each unit's bad faces on verify_faces_units' inputs (plain)."""
    from repro_torch.kernels.cptest import ref

    *rest, forced = args
    return [ref.verify_faces(*unit_args(tuple(rest) + (forced.clone(),), b))
            for b in range(args[0].shape[0])]


def selected_faces(args):
    """(N, 3) global vertex ids of the faces verify_faces re-checks on
    these inputs (the plain version's selection)."""
    from repro_torch.kernels.cptest import ref

    ur, st, sb = args[0], args[5], args[6]
    HW = ur.shape[1] * ur.shape[2]
    sel_sl, sel_sb = ref.selection(*args[:7])
    ts, fs = torch.nonzero(sel_sl, as_tuple=True)
    tb, fb = torch.nonzero(sel_sb, as_tuple=True)
    return torch.cat([st[fs] + ts[:, None] * HW, sb[fb] + tb[:, None] * HW])


def library_call(name, args):
    """One PyTorch call computing the kernel's function on the same
    inputs (its operands prepared outside the timing), or None."""
    if name != "symbol_histogram":
        return None
    sym = args[0]
    B = sym.shape[0]
    rows = torch.arange(B, dtype=torch.int64, device=sym.device)[:, None]
    keys = (sym.to(torch.int64) + (rows << 8)).reshape(-1)
    return lambda: torch.bincount(keys, minlength=B * 256)


def phase_table(main, tiled_run):
    mods = modules()
    mono = next(r for r in main
                if r["shape"] == SIZES["main"][0] and r["codec"] == "device")
    rows = []
    for name, mod, attr, src, replaces in KERNELS:
        kmod, rmod = mods[mod]
        run = tiled_run if name in TILED_ONLY else mono
        args = run["inputs"][name]
        kern = getattr(kmod, attr)
        plain = getattr(rmod, attr)
        saved = kern.launches
        if name in ("verify_faces", "verify_faces_units"):
            # forced is updated in place: each version gets its own copy,
            # and the mask is compared beside the count
            *rest, forced = args
            got_f, want_f = forced.clone(), forced.clone()
            got, want = kern(*rest, got_f), plain(*rest, want_f)
            assert same(got_f, want_f), f"{name}: forced masks differ"
        else:
            got = kern(*args)
            want = plain(*args)
        assert same(got, want), f"{name}: kernel != plain on main-path inputs"
        err = max_abs_err(got, want)
        call_ms = time_ms(lambda: kern(*args), 50)
        plain_ms = time_ms(lambda: plain(*args), 5)
        lib = library_call(name, args)
        if lib is not None:
            assert same(lib().reshape(want.shape).to(want.dtype), want)
        library_ms = time_ms(lib, 50) if lib is not None else None
        _, _, prof_rows = device_profile(
            lambda: [kern(*args) for _ in range(50)])
        dev_ms, n = kernel_rows(prof_rows)[name]
        # the kernel's own device time; the event-timed call time where
        # the profiler sees no device activity
        ms = dev_ms / n if n else call_ms
        kern.launches = saved
        nbytes, ops = bound_terms(name, args, want)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F64_FLOPS * 1e3
        shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
        how = (f"device, {n} profiled launches" if n
               else "per call: the profiler saw no device time")
        lib_txt = (f", library call {library_ms:.5f} ms"
                   if library_ms is not None else "")
        if name == "sl_decode":
            flags = args[5]
            xu, xv = decode_sl_pixels(args, want)
            lib_txt += (f", {int(flags[1:].sum())} grid barriers of "
                        f"{kern.grid} CTAs, {xu.numel()} SL pixels ("
                        f"{sl_branches(xu, xv, *args[7:])})")
        if name == "sl_step_batched":
            lib_txt += f" ({sl_branches(*args)})"
        if name == "sl_decode_units":
            lib_txt += (f", {int(args[5][:, 1:].any(0).sum())} grid barriers "
                        f"of {kern.grid} CTAs, units {args[0].shape[0]}")
        if name in ("verify_faces", "verify_faces_units"):
            n_faces = (args[7].numel() + args[8].numel())
            n_sel = (selected_faces(args).shape[0] if name == "verify_faces"
                     else sum(selected_faces(unit_args(args, b)).shape[0]
                              for b in range(args[0].shape[0])))
            lib_txt += (f", {n_faces} faces, {n_sel} selected "
                        f"({'screen' if args[4] is None else 'delta'}), "
                        f"{int(want)} bad")
        say(f"table {name}: main-path inputs {shapes}, kernel {ms:.5f} ms "
            f"({how}), {call_ms:.5f} ms per call "
            f"(CUDA events over 50 calls), plain {plain_ms:.5f} ms per "
            f"call{lib_txt}, bound {max(t_bytes, t_ops):.6f} ms "
            f"({nbytes} B, {ops:.0f} f64 ops), launches {run['launches'][name]}")
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": run["launches"][name],
            "max_abs_err": err, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
        })
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script drives the port on "
              "the card only", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    # REPRO_BACKEND=numpy refuses CUDA tensors (the plain versions run on
    # the CPU only), so every phase would raise
    assert not os.environ.get("REPRO_BACKEND"), "unset REPRO_BACKEND"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_all = time.perf_counter()
    say(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__},"
        f" CUDA {torch.version.cuda}")
    phase_build()
    phase_kernels(dev)
    phase_parity(dev)
    main_runs = phase_main(dev)
    adaptive_runs = phase_adaptive(dev, main_runs)
    phase_obs(dev, main_runs)
    tiled_run, tiled_runs = phase_tiled(dev, main_runs, adaptive_runs)
    stream_blob = phase_stream(dev, tiled_runs)
    phase_recovery(dev, stream_blob, tiled_runs)
    phase_query(dev, tiled_runs)
    phase_autotune(dev, main_runs)
    phase_serve(dev)
    phase_train(dev)
    phase_dryrun(dev)
    phase_shard(dev)
    rows = phase_table(main_runs, tiled_run)
    say(f"chip_smoke: all phases passed in {time.perf_counter() - t_all:.1f} s")
    say(json.dumps({"kernels": rows}))
    say(smi_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--shard-steps"] and torch.cuda.is_available():
        sys.path.insert(0, str(ROOT / "src"))
        sys.exit(shard_steps_child(sys.argv[2]))
    sys.exit(main())
