#!/usr/bin/env python3
"""First and second tiled compress at one unit geometry, on the card.

    python3 tools/tiled_first_call.py [T H W TILE_H TILE_W WINDOW_T]

Builds the kernels and compresses the first T frames of
``vortex_street(64, H, W)`` (default 4 x 512 x 512) with
``TileGrid(TILE_H, TILE_W, WINDOW_T)`` (default 256 x 512 x 64) and
batch_cap 4, a plan the tuner measures at that size, twice for each SL
stepper arm (the default, then "pallas", "xla", "pallas", the default
again), one card: synchronized host-clock seconds of each call, and the 30 most
costly functions (cProfile, cumulative) of any call over 2 s.  The
first call at a new unit plane builds the host tables of that geometry
(``core/grid.py``: the track index's ``tet_face_map``, the verify's
``device_tables`` and ``face_walk``), which are cached per plane
shape.
"""
import cProfile
import io
import pstats
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("tiled_first_call: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch as rt
    from repro_torch.data import synthetic

    args = [int(a) for a in sys.argv[1:]] or [4, 512, 512, 256, 512, 64]
    T, H, W, th, tw, wt = args
    dev = torch.device("cuda")
    cs.say(cs.smi_line())
    cs.phase_build()
    u, v = synthetic.vortex_street(T=64, H=H, W=W)
    u, v = u[:T].copy(), v[:T].copy()
    grid = rt.TileGrid(tile_h=th, tile_w=tw, window_t=wt)
    with cs.TilesDevices(lambda visible: visible[:1]):
        for be in (None, "pallas", "xla", "pallas", None):
            cfg = rt.CompressionConfig(backend=be, batch_cap=4,
                                       **cs.scf_meta(64, H, W))
            for i in range(2):
                prof = cProfile.Profile()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                prof.enable()
                rt.compress_tiled(u, v, cfg, grid, device=dev)
                torch.cuda.synchronize()
                prof.disable()
                s = time.perf_counter() - t0
                cs.say(f"tiled {T}x{H}x{W} in {th}x{tw}x{wt}, backend {be}, "
                       f"call {i}: {s:.4f} s (host clock)")
                if s > 2.0:
                    buf = io.StringIO()
                    pstats.Stats(prof, stream=buf).sort_stats(
                        "cumulative").print_stats(30)
                    cs.say(buf.getvalue())
    return 0


if __name__ == "__main__":
    sys.exit(main())
