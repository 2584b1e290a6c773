"""The control of the check: the plain reference's quantizer put in the
program's place.  It keeps the pointwise bound (every value rounded to
the nearest multiple of 2 eb) and nothing else, so it breaks the second
guarantee the configurations state, FC_t = FC_s = 0: a compressor that
derived no per-vertex bound from the critical points and ran no verify
loop would read so.  The check must find it not correct.

    python bench/control.py --workload <name> --seeds 11 12 13 --seconds 1

runs the cell with the control in place of ``repro_torch``'s compress and
decompress (set-up, window and check as a run does) and prints one JSON
line a seed with the numbers compared.  The benchmark's own runs never
run it.
"""
from __future__ import annotations

import io
import json
import sys
import time
import zlib
from pathlib import Path

import numpy as np

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])


class PlainQuantizer:
    """compress / decompress with the program's signatures: codes =
    round(x / (2 eb_abs)) as int64, zlib-packed; the decode multiplies
    back in float64 and rounds to float32."""

    @staticmethod
    def compress(u, v, cfg, device=None):
        from bench.reference import judge

        step = 2.0 * judge.eb_abs(u, v, cfg.eb, cfg.mode)
        # a step a hair under 2 eb keeps the float32 rounding inside eb
        step *= 1.0 - 1e-4
        buf = io.BytesIO()
        np.savez(buf, step=np.float64(step),
                 u=np.round(u.astype(np.float64) / step).astype(np.int64),
                 v=np.round(v.astype(np.float64) / step).astype(np.int64))
        blob = zlib.compress(buf.getvalue(), 1)
        return blob, {"ratio": (u.nbytes + v.nbytes) / len(blob)}

    @staticmethod
    def decompress(blob, backend=None, device=None):
        z = np.load(io.BytesIO(zlib.decompress(blob)))
        step = float(z["step"])
        return ((z["u"] * step).astype(np.float32),
                (z["v"] * step).astype(np.float32))


def main(argv=None) -> int:
    import argparse

    from bench import harness

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        result, _ = harness.run(args.workload, seed, args.seconds, False,
                                time.perf_counter(), program=PlainQuantizer)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
