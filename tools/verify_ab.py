#!/usr/bin/env python3
"""The verify_check stage of two source trees, on one card.

    python3 tools/verify_ab.py --parent DIR        # DIR: an older checkout

Runs one worker process per tree in the order parent, change, change,
parent (each imports ``repro_torch`` from its own ``src/`` and builds its
kernels into its own ``build/``) and prints one JSON line per worker,
then the card's name and power limit.  A worker, for the SCF analogue
vortex_street(T=120, H=100, W=225) and vortex_street(T=64, H=512, W=512)
with their generation metadata:

* compresses once (kernel builds, warm-up; ``codec="device"``), keeping
  the arguments of the first ``pipeline._verify_round`` call (the
  screen round);
* verify_check: host seconds of ``_verify_round`` (median of 5,
  synchronized), and under torch.profiler over 5 calls its device time
  per call, its device operations per call (kernels and copies), the
  K2 kernels' device time per call and its top device ops;
* the stage's transient device memory: peak allocated during one call
  minus the memory allocated before it;
* peak device memory of a whole compress with each codec
  (``max_memory_allocated`` after ``reset_peak_memory_stats``);
* in a tree with ``verify_faces``: its bound on these inputs, the
  compulsory bytes (the four int64 vertex arrays, both face tables once,
  the original predicate of each face the screen selects, three forced
  bytes a bad face) over 3.35 TB/s (H100 SXM HBM3), and the faces
  selected and bad;
* the container's size and digest, which both trees must share.

    python3 tools/verify_ab.py --worker SRC        # one tree

Card only; imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from k1_k5_ab import device_rows, pick

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(120, 100, 225), (64, 512, 512)]
HBM_BYTES_PER_S = 3.35e12


def bound(args) -> dict:
    """verify_faces' compulsory bytes and bound on its screen-round
    arguments, and the faces it visits and selects."""
    from repro_torch.kernels.cptest import ref

    ur, st, sb, forced = args[0], args[5], args[6], args[9]
    sel_sl, sel_sb = ref.selection(*args[:7])
    n_sel = int(sel_sl.sum()) + int(sel_sb.sum())
    n_bad = int(ref.verify_faces(*args[:9], forced.clone()))
    nbytes = ur.numel() * 32 + (st.numel() + sb.numel()) * 8 + n_sel \
        + 3 * n_bad
    return {"faces": sel_sl.numel() + sel_sb.numel(), "selected": n_sel,
            "bad": n_bad, "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def stage(args, fn) -> dict:
    import torch

    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    rows = device_rows(lambda: fn(*args), 5)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn(*args)
    torch.cuda.synchronize()
    transient = torch.cuda.max_memory_allocated() - base
    k2_ms = {k: pick(rows, f"{k}_kernel(")[0]
             for k in ("verify_faces", "face_crossed")}
    return {
        "host_s": statistics.median(host),
        "host_all_s": host,
        "device_ms": sum(r[1] for r in rows),
        "device_ops": sum(r[2] for r in rows),
        "k2_device_ms": k2_ms,
        "transient_mib": transient / 2 ** 20,
        "top": [(n[:70], round(ms, 5), c) for n, ms, c in rows[:10]],
    }


def worker(src: str) -> dict:
    sys.path.insert(0, src)
    import torch
    import repro_torch as rt
    from repro_torch.core import backend, pipeline
    from repro_torch.data import synthetic

    dev = torch.device("cuda")
    out = {"tree": src}
    for T, H, W in SHAPES:
        u, v = synthetic.vortex_street(T=T, H=H, W=W)
        meta = dict(dt=0.05, dx=2.0 / (W - 1), dy=1.0 / (H - 1))
        seen = {}
        orig = pipeline._verify_round
        orig_vf = getattr(backend, "verify_faces", None)

        def keep(*args):
            seen.setdefault("round", args)
            return orig(*args)

        def keep_vf(*args):
            seen.setdefault("vf", tuple(
                a.clone() if torch.is_tensor(a) else a for a in args))
            return orig_vf(*args)
        pipeline._verify_round = keep
        if orig_vf is not None:
            backend.verify_faces = keep_vf
        cfg = rt.CompressionConfig(codec="device", **meta)
        blob, stats = rt.compress(u, v, cfg, device=dev)
        pipeline._verify_round = orig
        if orig_vf is not None:
            backend.verify_faces = orig_vf
        res = stage(seen["round"], orig)
        if "vf" in seen:
            res["verify_faces_bound"] = bound(seen["vf"])
        seen.clear()
        res["bytes"] = len(blob)
        res["sha256"] = hashlib.sha256(blob).hexdigest()[:16]
        res["verify_rounds"] = stats["verify_rounds"]
        peak = {}
        for codec in ("host", "device"):
            cfg = rt.CompressionConfig(codec=codec, **meta)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            rt.compress(u, v, cfg, device=dev)
            torch.cuda.synchronize()
            peak[codec] = torch.cuda.max_memory_allocated() / 2 ** 20
        res["compress_peak_mib"] = peak
        out["x".join(map(str, (T, H, W)))] = res
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="root of the older tree")
    ap.add_argument("--worker", help="src/ directory of one tree")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("verify_ab: no CUDA device", file=sys.stderr)
        return 2
    if a.worker:
        print(json.dumps(worker(a.worker)), flush=True)
        return 0
    if not a.parent:
        ap.error("--parent or --worker is required")
    trees = {"parent": str(Path(a.parent).resolve() / "src"),
             "change": str(ROOT / "src")}
    for name in ("parent", "change", "change", "parent"):
        res = subprocess.run([sys.executable, __file__, "--worker",
                              trees[name]], capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            raise SystemExit(f"verify_ab: the {name} worker failed")
        print(name, res.stdout.strip().splitlines()[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
