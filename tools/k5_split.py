#!/usr/bin/env python3
"""Where K5's time goes (csrc/entropy.cu), on one card.

    python3 tools/k5_split.py

Captures the symbol rows that the device codec hands K5 on the SCF
analogue (vortex_street 120x100x225, default config) and prints their
symbol shares.  Builds copies of the source with the production nvcc
flags: the shipped kernel; its grid at one and at three CTAs an SM; one
that returns before the finishing chain (fence, per-row ticket, last
CTA); one that loads nothing; one that does neither.  Times each copy
(device time per launch under torch.profiler, 50 launches) on the real
rows, on all-zero rows of the same shape and on the real rows repeated
8 times, in the order there and back.  The shipped kernel and the grid
variants must equal the plain version.  Prints one JSON line and the
card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import repro_torch as rt  # noqa: E402
from repro_torch.core import backend  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.entropy import ref as r5  # noqa: E402

SRC = _build.CSRC / "entropy.cu"
OUT = _build.BUILD_DIR.parent / "k5_split"
TAIL = "  __threadfence();\n  __syncthreads();\n  if (threadIdx.x == 0)\n"
LOAD = "  const int64_t nvec = (n - head) >> 4;\n"
CTAS = "constexpr int kCtasPerSm = 2;"
# name: (edits, counts must be exact)
VARIANTS = {
    "shipped": ([], True),
    "ctas_per_sm_1": ([(CTAS, "constexpr int kCtasPerSm = 1;")], True),
    "ctas_per_sm_3": ([(CTAS, "constexpr int kCtasPerSm = 3;")], True),
    "no_finish": ([(TAIL, "  return;\n" + TAIL)], False),
    "no_load": ([(LOAD, "  const int64_t nvec = 0;\n")], False),
    "no_load_no_finish": ([(LOAD, "  const int64_t nvec = 0;\n"),
                           (TAIL, "  return;\n" + TAIL)], False),
}


def build() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (edits, _) in VARIANTS.items():
        text = SRC.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: anchor not found once: {old!r}")
            text = text.replace(old, new)
        src = OUT / f"{name}.cu"
        src.write_text(text)
        lib = OUT / f"lib{name}.so"
        cmd = [_build.nvcc(), *_build._flags("entropy"), "-o", str(lib),
               str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (p, lib) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        f = ctypes.CDLL(str(lib)).symbol_histogram
        f.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        f.restype = ctypes.c_int
        libs[name] = f
    return libs


def launch(f, sym, work):
    B, n = sym.shape
    hist = torch.empty((B, 256), dtype=torch.int32, device=sym.device)
    _build.check(f(sym.data_ptr(), B, n, hist.data_ptr(), work.data_ptr(),
                   _build.stream_ptr(sym.device)), "symbol_histogram")
    return hist


def device_ms(fn, reps=50) -> float:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "symbol_histogram_kernel(" in e.key]
    n = sum(e.count for e in hits)
    return sum(e.self_device_time_total for e in hits) / 1e3 / n if n else 0.0


def main() -> int:
    if not torch.cuda.is_available():
        print("k5_split: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    T, H, W = 120, 100, 225
    u, v = synthetic.vortex_street(T=T, H=H, W=W)
    cfg = rt.CompressionConfig(codec="device", dt=0.05, dx=2.0 / (W - 1),
                               dy=1.0 / (H - 1))
    seen = {}
    orig = backend.symbol_histogram

    def keep(sym):
        seen.setdefault("sym", sym.clone())
        return orig(sym)
    backend.symbol_histogram = keep
    rt.compress(u, v, cfg, device=dev)
    backend.symbol_histogram = orig
    real = seen["sym"]
    counts = r5.symbol_histogram(real).sum(0).double()
    words = real[:, :real.shape[1] // 4 * 4].reshape(real.shape[0], -1, 4)
    shares = {
        "rows": list(real.shape),
        "symbol_share_0_to_5": [float(x) for x in counts[:6] / counts.sum()],
        "symbol_share_ge5": float(counts[5:].sum() / counts.sum()),
        "word_share_with_a_byte_ge5": float((words >= 5).any(-1).double()
                                            .mean()),
    }
    inputs = {"real": real, "zeros": torch.zeros_like(real),
              "real_x8": real.repeat(1, 8).contiguous()}
    libs = build()
    times = {}
    for key, sym in inputs.items():
        want = r5.symbol_histogram(sym)
        order = list(VARIANTS) + list(VARIANTS)[::-1]
        for name in order:
            work = torch.zeros(sym.shape[0] * 257, dtype=torch.int32,
                               device=dev)
            got = launch(libs[name], sym, work)
            torch.cuda.synchronize()
            if VARIANTS[name][1] and not torch.equal(got, want):
                raise AssertionError(f"{name} differs from plain on {key}")
            times.setdefault(key, {}).setdefault(name, []).append(
                device_ms(lambda: launch(libs[name], sym, work)))
    print(json.dumps({"symbols": shares, "device_ms": times}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
