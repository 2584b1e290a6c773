#!/usr/bin/env python3
"""chip_smoke's phase 4n (the "pallas" and "xla" SL steppers) alone, on
the card, with phase 5's rows of their kernels.

    python3 tools/steppers_phase.py [--tests]

Builds the kernels and calls ``chip_smoke.phase_steppers`` (compress ->
decompress with backend="pallas" at 64x512x512 and at the SCF analogue,
monolithic and tiled, launch counts, each variant kernel == its plain
version on those runs' inputs, card bytes == CPU bytes, the golden
containers) and ``chip_smoke.phase_table`` over ``STEPPER_KERNELS``
(time, plain time, bound, and the "numpy" kernel on the same inputs),
printing the rows as one JSON line.  ``--tests`` then runs
tests/test_torch_cuda_sl_variants.py.  Exits non-zero if a check fails.
Phase 4n runs here without the earlier phases' warm caches, so its
seconds exceed those of a whole chip_smoke run.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("steppers_phase: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cs.say(cs.smi_line())
    cs.phase_build()
    with cs.TilesDevices(lambda visible: visible[:1]):
        rows = cs.phase_steppers(dev)
    cs.say(json.dumps({"kernels": cs.phase_table(None, None, rows,
                                                 cs.STEPPER_KERNELS)}))
    if "--tests" not in sys.argv:
        return 0
    r = subprocess.run([sys.executable, "-m", "pytest", "-q", "--noconftest",
                        "-p", "no:cacheprovider", "-rs",
                        "tests/test_torch_cuda_sl_variants.py"], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    return r.returncode


if __name__ == "__main__":
    sys.exit(main())
