#!/usr/bin/env python3
"""chip_smoke's phase 4m (the compressor's tiles mesh) alone, on the card.

    python3 tools/tiles_phase.py [--kernels] [--all-tests]

Builds the kernels, makes the inputs phase 4m reads from the earlier
phases -- the monolithic compress -> decompress of vortex_street(T=64,
H=512, W=512) and its tiled compress with TileGrid(128, 128, 32) on one
card, each codec, timed on a second call -- and calls
``chip_smoke.phase_tiles``: the mesh [cuda:0], then [cuda:0, cuda:0],
and with several visible cards every card and ``device="cuda:1"``.
``--kernels`` runs phase 2 (every kernel against its plain version)
first; ``--all-tests`` then runs every card test file (otherwise the
tiles-mesh card tests only).  Exits non-zero if a check fails.
"""
import os
import subprocess
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
        print("tiles_phase: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch as rt
    from repro_torch.data import synthetic

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cs.say(f"{cs.smi_line()}; {torch.cuda.device_count()} cards visible")
    cs.phase_build()
    if "--kernels" in sys.argv:
        cs.phase_kernels(dev)
    T, H, W = cs.SIZES["tiled"][-1][0]
    u, v = synthetic.vortex_street(T=T, H=H, W=W)
    grid = rt.TileGrid(*cs.SIZES["tile_grid"])
    main_runs, tiled = [], {}
    with cs.TilesDevices(lambda visible: visible[:1]):
        for codec in ("host", "device"):
            cfg = rt.CompressionConfig(codec=codec, **cs.scf_meta(T, H, W))
            blob, _ = rt.compress(u, v, cfg, device=dev)
            main_runs.append({"shape": (T, H, W), "codec": codec,
                              "blob": blob,
                              "dec": rt.decompress(blob, device=dev)})
            rt.compress_tiled(u, v, cfg, grid, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tb, _ = rt.compress_tiled(u, v, cfg, grid, device=dev)
            torch.cuda.synchronize()
            tiled[(T, H, W), codec] = {"blob": tb,
                                       "enc_s": time.perf_counter() - t0}
            cs.say(f"one-card tiled {codec}: {len(tb)} B, "
                   f"{tiled[(T, H, W), codec]['enc_s']:.3f} s")
    cs.phase_tiles(dev, main_runs, tiled)
    tests = (["tests/test_torch_cuda.py", "tests/test_torch_cuda_units.py",
              "tests/test_torch_cuda_stream.py",
              "tests/test_torch_cuda_autotune.py",
              "tests/test_torch_cuda_perfflags.py",
              "tests/test_torch_tiles_mesh.py", "-k",
              "not reference_map_tiles"] if "--all-tests" in sys.argv else
             ["tests/test_torch_cuda_units.py",
              "tests/test_torch_tiles_mesh.py", "-k",
              "launches_run_on or tiles_devices or tiled_blob"])
    r = subprocess.run([sys.executable, "-m", "pytest", "-q", "--noconftest",
                        "-p", "no:cacheprovider", "-rs", *tests], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    return r.returncode


if __name__ == "__main__":
    sys.exit(main())
