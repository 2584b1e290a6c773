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
              == the CPU's
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
              device-codec stream of T = 192 (resident frames at the
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
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the f64 rate
# outside the tensor cores (the stepper's scalar f64 cannot use them)
HBM_BYTES_PER_S = 3.35e12
F64_FLOPS = 34e12

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
    # stream's length; the recovery children's kill points (frames) at
    # the SCF analogue: mid-stream and before the last frame
    "stream": (64, 512, 512),
    "stream_long": 192,
    "kill_at": (100, 119),
}

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
        say(f"{tag}: max err {err!r} <= eb_abs "
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
    device busy share; then one async device-codec stream of T = 192.
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
    rows = phase_table(main_runs, tiled_run)
    say(f"chip_smoke: all phases passed in {time.perf_counter() - t_all:.1f} s")
    say(json.dumps({"kernels": rows}))
    say(smi_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
