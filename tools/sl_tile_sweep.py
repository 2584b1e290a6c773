#!/usr/bin/env python3
"""Time variants of the SL kernels (csrc/semilagrange.cu) on one card.

    python3 tools/sl_tile_sweep.py [--parent OLD_semilagrange.cu]

Builds copies of the source whose tile and halo constants are changed
(K4's 32x16 tile and 4-cell halo, sl_decode's 8-cell halo), each with
the production nvcc flags, and times K4 (``sl_step_batched``) and K3
(``sl_decode``) of every copy on the inputs the main path gives them on
the SCF analogue (vortex_street 120x100x225, default config), in the
order there and back.  Every copy must return the production kernel's
integers bit for bit.  ``--parent`` adds an older source with the same
``sl_step_batched`` entry point as a K4 baseline, ``--k3-baseline`` an
older source with the same ``sl_decode`` entry point as a K3 baseline
(the entry points that take the stepper variant, which is the f64
"numpy" one here).
Then it splits the
production ``sl_decode``'s time on the same inputs: all frames with no
flag (no barrier, no SL step: each thread's prefix sum in registers),
the flags kept but an empty blockmap (the grid barriers, no SL step),
and the real inputs.  Prints one JSON line of mean ms per call (CUDA
events) and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import types
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import repro_torch as rt  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.semilagrange import kernel as k3  # noqa: E402
from repro_torch.kernels.semilagrange import ops as sl_ops  # noqa: E402

SRC = _build.CSRC / "semilagrange.cu"
OUT = _build.BUILD_DIR.parent / "sl_sweep"
K4_SHAPES = [(32, 16, 4), (32, 32, 4), (16, 16, 4), (16, 32, 4), (8, 32, 4),
             (32, 16, 8)]
DEC_HALOS = [4, 6, 8, 12]
# the entry points' code of the f64 "numpy" stepper, the main path's
NUMPY = 0


def variant(th, tw, k4_halo, dec_halo) -> str:
    text = SRC.read_text()
    for name, value in (("K4_TH", th), ("K4_TW", tw), ("K4_HALO", k4_halo),
                        ("DEC_HALO", dec_halo)):
        line = next(ln for ln in text.splitlines()
                    if ln.startswith(f"constexpr int {name} = "))
        text = text.replace(line, f"constexpr int {name} = {value};")
    return text


def build(sources: dict) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        cmd = [_build.nvcc(), *_build._flags("semilagrange"), "-o",
               str(OUT / f"lib{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        libs[name] = ctypes.CDLL(str(OUT / f"lib{name}.so"))
    return libs


def capture():
    """The arguments of K4 and K3 in one SCF compress on the card."""
    T, H, W = 120, 100, 225
    u, v = synthetic.vortex_street(T=T, H=H, W=W)
    cfg = rt.CompressionConfig(dt=0.05, dx=2.0 / (W - 1), dy=1.0 / (H - 1))
    got = {}

    def keep(name, fn):
        def call(*args):
            got[name] = tuple(a.clone() if torch.is_tensor(a) else a
                              for a in args)
            return fn(*args)
        return call

    saved = sl_ops.kernel
    sl_ops.kernel = types.SimpleNamespace(
        sl_step_batched=keep("k4", k3.sl_step_batched),
        sl_decode=keep("k3", k3.sl_decode))
    try:
        rt.compress(u, v, cfg, device="cuda")
    finally:
        sl_ops.kernel = saved
    return got["k4"], got["k3"]


def time_ms(fn, reps: int) -> float:
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


def k4_call(lib, args):
    xu, xv, g2f, cx, cy, d_max, n_max = args
    f = lib.sl_step_batched
    f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_double] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    f.restype = ctypes.c_int
    pu, pv = torch.empty_like(xu), torch.empty_like(xv)
    stream = _build.stream_ptr(xu.device)

    def run():
        _build.check(f(xu.data_ptr(), xv.data_ptr(), pu.data_ptr(),
                       pv.data_ptr(), *xu.shape, g2f, cx, cy, d_max, n_max,
                       NUMPY, stream), "sl_step_batched")
    return run, (pu, pv)


def k3_call(lib, args):
    c2u, c2v, ru, rv, bm, flags, block, g2f, cx, cy, d_max, n_max = args
    f = lib.sl_decode
    f.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_double] * 4 + [ctypes.c_int, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_int),
                                ctypes.c_void_p]
    f.restype = ctypes.c_int
    xu, xv = torch.empty_like(c2u), torch.empty_like(c2v)
    grid = ctypes.c_int(0)
    stream = _build.stream_ptr(c2u.device)

    def run():
        _build.check(f(c2u.data_ptr(), c2v.data_ptr(), ru.data_ptr(),
                       rv.data_ptr(), bm.data_ptr(), flags.data_ptr(),
                       xu.data_ptr(), xv.data_ptr(), *c2u.shape, block, g2f,
                       cx, cy, d_max, n_max, NUMPY, ctypes.byref(grid),
                       stream),
                     "sl_decode")
    return run, (xu, xv)


def sweep(libs, names, make, args, want, reps):
    times = {n: [] for n in names}
    for name in names + names[::-1]:
        run, out = make(libs[name], args)
        times[name].append(time_ms(run, reps))
        if not all(torch.equal(a, b) for a, b in zip(out, want)):
            raise AssertionError(f"{name} differs from the production kernel")
    return times


def decode_breakdown(args, reps):
    """sl_decode's ms with no flag, with the flags but no SL block, and
    as given; the first two must equal the prefix sum of c2."""
    c2u, c2v, ru, rv, bm, flags = args[:6]
    cases = {"no_barrier": (torch.zeros_like(bm), torch.zeros_like(flags)),
             "barriers_only": (torch.zeros_like(bm), flags),
             "production": (bm, flags)}
    prefix = (torch.cumsum(c2u, 0), torch.cumsum(c2v, 0))
    times = {n: [] for n in cases}
    for name in list(cases) + list(cases)[::-1]:
        case = (c2u, c2v, ru, rv, *cases[name]) + args[6:]
        times[name].append(time_ms(lambda: k3.sl_decode(*case), reps))
        if name != "production":
            out = k3.sl_decode(*case)
            assert all(torch.equal(a, b) for a, b in zip(out, prefix)), name
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path,
                    help="an older semilagrange.cu, as a K4 baseline")
    ap.add_argument("--k3-baseline", type=Path,
                    help="an older semilagrange.cu, as a K3 baseline")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("sl_tile_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    sources = {f"k4_{th}x{tw}_halo{h}": variant(th, tw, h, 8)
               for th, tw, h in K4_SHAPES}
    sources.update({f"k3_halo{h}": variant(32, 16, 4, h) for h in DEC_HALOS})
    if opts.parent:
        sources["k4_parent"] = opts.parent.read_text()
    if opts.k3_baseline:
        sources["k3_baseline"] = opts.k3_baseline.read_text()
    libs = build(sources)
    k4_args, k3_args = capture()
    k4_want = k3.sl_step_batched(*k4_args)
    k3_want = k3.sl_decode(*k3_args)
    k4_names = [n for n in sources if n.startswith("k4_")]
    k3_names = [n for n in sources if n.startswith("k3_")]
    result = {
        "k4_ms": sweep(libs, k4_names, k4_call, k4_args, k4_want, 100),
        "k3_ms": sweep(libs, k3_names, k3_call, k3_args, k3_want, 50),
        "k3_breakdown_ms": decode_breakdown(k3_args, 50),
        "k3_barriers": int(k3_args[5][1:].sum()),
        "k4_input": list(k4_args[0].shape),
        "k3_input": list(k3_args[0].shape), "k3_grid": k3.sl_decode.grid,
    }
    print(json.dumps(result))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
