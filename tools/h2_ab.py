#!/usr/bin/env python3
"""The cost of perf iteration H2 on the train step, on one card.

    python3 tools/h2_ab.py [--steps 10] [--out chiprun_out/h2_ab.json]
    python3 tools/h2_ab.py --predict-only --device cpu

H2 recomputes each Mamba and RWKV chunk body in the backward pass
(``perfflags.checkpoint_if_optimized``), inside the block recompute the
train loss already does, so a chunk's forward runs three times a step
where it ran twice.  For each case below this times the train step of
``launch.dryrun.make_step`` (AdamW, zero tokens) in the order H2 on, H2
off, H2 off, H2 on ("off": ``checkpoint_if_optimized`` replaced by the
identity; the rest of the step unchanged), then once with
``REPRO_PERF_BASELINE``'s ``BASELINE`` set (H2, H3 and H5 reverted).
Per run it prints one JSON line:

* ``step_ms``: the median host time of ``--steps`` synchronized steps
  after two warm-up steps;
* ``device_ms`` / ``device_ops``: summed device self time and the
  number of device operations of one step under torch.profiler;
* ``peak_mib``: ``max_memory_allocated`` over the timed steps less the
  memory allocated before them (parameters and optimizer state);
* ``ops``: the aten ops one step dispatches (``opcost.CostMode``).

Cases: the Jamba and RWKV SMOKE configs at the train launcher's 8 x 128,
and rwkv6-3b at its published width cut to 4 of its 32 layers at 8 x 128
(Jamba's published width does not fit one card: one MoE layer holds
9.7 B parameters).  Then, for the last case at 8 x 1024, the dry run's
predicted peak with H2 on and off (``--predict-only``: that alone; it
traces on fake tensors, so it needs no card).  Last it prints the card's
name and power limit.  Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CASES = [("jamba_1_5_large", "SMOKE", None), ("rwkv6_3b", "SMOKE", None),
         ("rwkv6_3b", "CONFIG", 4)]
BATCH, SEQ = 8, 128
PREDICT_SEQ = 1024


def model_cfg(arch, which, layers):
    import repro_torch.configs as C

    cfg = getattr(C.get(arch), which)
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def device_time(fn):
    """(device ms, device ops) of one call of ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key != "Activity Buffer Request"
            and e.self_device_time_total > 0]
    return (sum(e.self_device_time_total for e in rows) / 1e3,
            sum(e.count for e in rows))


@contextlib.contextmanager
def variant_flags(variant):
    """H2 on (the default), H2 off, or BASELINE."""
    from repro_torch import perfflags

    saved = perfflags.checkpoint_if_optimized, perfflags.BASELINE
    if variant == "h2_off":
        perfflags.checkpoint_if_optimized = lambda fn: fn
    perfflags.BASELINE = variant == "baseline"
    try:
        yield
    finally:
        perfflags.checkpoint_if_optimized, perfflags.BASELINE = saved


def predict(arch, which, layers, variant, dev):
    """The dry run's predicted peak (MiB above the arguments) and op count
    of the train step at BATCH x PREDICT_SEQ, traced on fake tensors."""
    from repro_torch.configs import CellSpec
    from repro_torch.launch import dryrun
    from repro_torch.models.transformer import build_model

    cfg = model_cfg(arch, which, layers)
    with variant_flags(variant), dryrun.fake_tensors():
        model = build_model(cfg, device=dev)
        fn, _ = dryrun.make_step(model, CellSpec("train", PREDICT_SEQ,
                                                 BATCH), dev)
        cost, _, _ = dryrun.trace(fn)
    return {"arch": cfg.name, "layers": cfg.n_layers, "batch": BATCH,
            "seq": PREDICT_SEQ, "variant": variant,
            "predicted_peak_mib": cost.peak_bytes / 2**20,
            "ops": sum(cost.op_counts.values())}


def run(arch, which, layers, variant, steps, dev):
    from repro_torch.configs import CellSpec
    from repro_torch.launch import dryrun
    from repro_torch.models.transformer import build_model
    from repro_torch.opcost import CostMode

    with variant_flags(variant):
        cfg = model_cfg(arch, which, layers)
        model = build_model(cfg, device=dev, seed=0)
        fn, _ = dryrun.make_step(model, CellSpec("train", SEQ, BATCH), dev)
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = (torch.cuda.max_memory_allocated() - held) / 2**20
        dev_ms, dev_ops = device_time(fn)
        with CostMode() as cm:
            fn()
        torch.cuda.synchronize()
        return {"arch": cfg.name, "layers": cfg.n_layers,
                "batch": BATCH, "seq": SEQ, "variant": variant,
                "step_ms": statistics.median(times) * 1e3,
                "step_ms_all": [t * 1e3 for t in times],
                "device_ms": dev_ms, "device_ops": dev_ops,
                "peak_mib": peak, "ops": sum(cm.cost.op_counts.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default=None)
    ap.add_argument("--predict-only", action="store_true",
                    help="only the dry run's predicted peaks")
    ap.add_argument("--device", default=None,
                    help="device of the fake tensors with --predict-only "
                         "(default: the CUDA device)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device or "cuda")
    if (dev.type == "cuda" or not args.predict_only) \
            and not torch.cuda.is_available():
        print("h2_ab: no CUDA device (--predict-only --device cpu traces "
              "on this host)", file=sys.stderr)
        return 2
    if not args.predict_only and dev.type != "cuda":
        print("h2_ab: the timed steps run on the card only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for arch, which, layers in [] if args.predict_only else CASES:
        for variant in ("h2_on", "h2_off", "h2_off", "h2_on", "baseline"):
            row = run(arch, which, layers, variant, args.steps, dev)
            print(json.dumps(row), flush=True)
            rows.append(row)
            torch.cuda.empty_cache()
    for variant in ("h2_on", "h2_off"):
        row = predict(*CASES[-1], variant, dev)
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
