"""A throwaway benchmark root at CPU test sizes: BENCHMARK.json with tiny
cells over the real harness, generators and readers (copied), so a test
can add files to it and run a cell on the CPU."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CONFIGS = {
    "mono-tiny": {
        "source": "test size", "reduced": [], "assumed": {},
        "field": {"generator": "vortex_street", "H": 24, "W": 40, "seed": 3},
        "chunk_frames": 6,
        "compressor": {"eb": 0.05, "mode": "rel", "predictor": "mop",
                       "block": 16, "codec": "device"},
        "tiling": None},
    "tiled-tiny": {
        "source": "test size", "reduced": [], "assumed": {},
        "field": {"generator": "heated_plume", "H": 30, "W": 20, "seed": 3},
        "chunk_frames": 8,
        "compressor": {"eb": 0.05, "mode": "rel", "predictor": "mop",
                       "block": 16, "codec": "host", "track_index": True},
        "tiling": {"tile_h": 16, "tile_w": 12, "window_t": 4, "halo": 1,
                   "thalo": 1}},
}
TINY_MIXES = {
    "write": {"op": "write", "loop": "closed", "pool_chunks": 2,
              "check_chunks": 2, "end": "pass"},
    "read": {"op": "read", "loop": "closed", "pool_chunks": 2,
             "end": "call"},
}


def make_root(tmp: Path) -> Path:
    """A copy of the benchmark's directory under ``tmp`` with tiny
    configurations and mixes, and a BENCHMARK.json naming tiny cells with
    the real metrics."""
    shutil.copytree(ROOT / "bench", tmp / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, cfg in TINY_CONFIGS.items():
        (tmp / "bench" / "configs" / f"{name}.json").write_text(
            json.dumps(cfg))
    for name, mix in TINY_MIXES.items():
        (tmp / "bench" / "mixes" / f"tiny-{name}.json").write_text(
            json.dumps(mix))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = [("mono-tiny", "write"), ("mono-tiny", "read"),
             ("tiled-tiny", "write")]
    real = {w["name"]: w for w in bench["workloads"]}
    twin = {("mono-tiny", "write"): "fs512-device.write",
            ("mono-tiny", "read"): "fs512-device.read",
            ("tiled-tiny", "write"): "hcba450-tiled.write"}
    bench["workloads"] = [
        {"name": f"{c}.{t}", "config": c, "traffic": f"tiny-{t}",
         "chips": 1, "why": real[twin[c, t]]["why"]} for c, t in cells]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [f"{c}.{t}" for c, t in cells
                              if twin[c, t] in m["workloads"]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp


def run(root: Path, cell: str, seed: int = 7, trace: bool = False,
        seconds: float = 0.0, program=None):
    """One run of a tiny cell on the CPU: (result, checks)."""
    import time

    from bench import harness

    return harness.run(cell, seed, seconds, trace, time.perf_counter(),
                       root=root, device="cpu", program=program)
