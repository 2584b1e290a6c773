#!/usr/bin/env python3
"""K1, K5 and the quantize_predict stage of two source trees, on one card.

    python3 tools/k1_k5_ab.py --parent DIR        # DIR: an older checkout

Runs one worker process per tree in the order parent, change, change,
parent (each imports ``repro_torch`` from its own ``src/`` and builds its
kernels into its own ``build/``), on the SCF analogue
vortex_street(T=120, H=100, W=225) with ``codec="device"``, and prints one
JSON line per worker, then the card's name and power limit.  A worker:

* compresses once (kernel builds, warm-up), keeping the inputs of the
  first ``pipeline._encode_field`` call and of ``backend.symbol_histogram``;
* quantize_predict: host seconds of ``_encode_field`` (median of 5,
  synchronized) and, under torch.profiler over 5 calls, its device time
  per call, K1's device time and launches per call, and its top device
  ops;
* K5 on the captured symbols: device time per launch (profiler, 50
  calls), call time (CUDA events over 50 back-to-back calls) and the
  device ops each call issues;
* with ``--sweep`` (trees whose K1 wrapper takes ``run``): K1's device
  time per launch on the captured inputs for several frame runs.

    python3 tools/k1_k5_ab.py --worker SRC [--sweep]   # one tree

Card only; imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (120, 100, 225)
RUNS = (1, 2, 3, 4, 6, 8, 15, 30, 60, 120)


def device_rows(fn, reps):
    """[(name, device ms per rep, launches per rep)] of ``reps`` calls of
    ``fn`` under torch.profiler, device-side events only."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3 / reps, e.count / reps)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key != "Activity Buffer Request"
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return rows


def pick(rows, fragment):
    hits = [r for r in rows if fragment in r[0]]
    return sum(r[1] for r in hits), sum(r[2] for r in hits)


def event_ms(fn, reps):
    import torch

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


def worker(src: str, sweep: bool) -> dict:
    sys.path.insert(0, src)
    import torch
    import repro_torch as rt
    from repro_torch.core import backend, pipeline
    from repro_torch.data import synthetic
    from repro_torch.kernels.lorenzo import kernel as k1

    dev = torch.device("cuda")
    T, H, W = SHAPE
    u, v = synthetic.vortex_street(T=T, H=H, W=W)
    cfg = rt.CompressionConfig(codec="device", dt=0.05, dx=2.0 / (W - 1),
                               dy=1.0 / (H - 1))
    seen = {}
    enc, hist = pipeline._encode_field, backend.symbol_histogram

    def keep_enc(*args):
        seen.setdefault("enc", args)
        return enc(*args)

    def keep_hist(sym):
        seen.setdefault("sym", sym.clone())
        return hist(sym)
    pipeline._encode_field, backend.symbol_histogram = keep_enc, keep_hist
    blob, stats = rt.compress(u, v, cfg, device=dev)
    pipeline._encode_field, backend.symbol_histogram = enc, hist

    args = seen["enc"]
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc(*args)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    rows = device_rows(lambda: enc(*args), 5)
    k1_ms, k1_n = pick(rows, "lorenzo_residual_kernel(")
    out = {
        "tree": src, "bytes": len(blob),
        "sha256": hashlib.sha256(blob).hexdigest()[:16],
        "verify_rounds": stats["verify_rounds"],
        "qp_host_s": statistics.median(host),
        "qp_device_ms": sum(r[1] for r in rows),
        "qp_device_launches": sum(r[2] for r in rows),
        "k1_device_ms": k1_ms, "k1_launches": k1_n,
        "qp_top": [(n[:70], round(ms, 5), c) for n, ms, c in rows[:12]],
    }
    sym = seen["sym"]
    rows = device_rows(lambda: backend.symbol_histogram(sym), 50)
    out["k5_device_ms"], _ = pick(rows, "symbol_histogram_kernel(")
    out["k5_call_ms"] = event_ms(lambda: backend.symbol_histogram(sym), 50)
    out["k5_call_ops"] = [(n[:70], round(ms, 5), c) for n, ms, c in rows]
    if sweep and "run" in inspect.signature(k1.lorenzo_residual).parameters:
        ufp, vfp, eb_vertex, extra = args[1:5]
        k, ll = pipeline._levels(eb_vertex, extra, args[0].plan.xi_unit,
                                 args[0].plan.n_levels)
        k = k.to(torch.int32).contiguous()
        xi, block = args[0].plan.xi_unit, args[0].plan.block
        out["k1_auto_run"] = k1.run_length(T, H, W, dev)
        out["k1_sweep_ms"] = {}
        for run in RUNS:
            rows = device_rows(lambda: k1.lorenzo_residual(
                ufp, vfp, k, ll, xi, block, True, run), 20)
            out["k1_sweep_ms"][run] = pick(rows, "lorenzo_residual_kernel(")[0]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="root of the older tree")
    ap.add_argument("--worker", help="src/ directory of one tree")
    ap.add_argument("--sweep", action="store_true")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k1_k5_ab: no CUDA device", file=sys.stderr)
        return 2
    if a.worker:
        print(json.dumps(worker(a.worker, a.sweep)), flush=True)
        return 0
    if not a.parent:
        ap.error("--parent or --worker is required")
    trees = {"parent": str(Path(a.parent).resolve() / "src"),
             "change": str(ROOT / "src")}
    for name in ("parent", "change", "change", "parent"):
        cmd = [sys.executable, __file__, "--worker", trees[name]]
        if name == "change":
            cmd.append("--sweep")
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            raise SystemExit(f"k1_k5_ab: the {name} worker failed")
        print(name, res.stdout.strip().splitlines()[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
