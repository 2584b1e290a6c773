#!/usr/bin/env python3
"""chip_smoke's phase 4o (the legacy binding and the decode-side
``backend=``) alone, on the card.

    python3 tools/legacy_phase.py [--tests]

Builds the kernels and calls ``chip_smoke.phase_legacy``: a
``fused=False`` compress -> decompress of the SCF analogue with each
codec (the legacy header, the bound, FC = 0, the launches of every
kernel wrapper over each run: K1 none, the "xla" K4 and K3 and K2's
``face_crossed``, no other stepper variant; the legacy and the fused
encode seconds), each of those kernels == its plain version on the
inputs the runs gave it, card bytes == CPU bytes on the tests' legacy
fields, and the golden containers decoded on the card with each
``backend=`` the card runs == the JAX package's stored decodes.
``--tests`` then runs tests/test_torch_cuda_legacy.py.  Exits non-zero
if a check fails.
"""
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
        print("legacy_phase: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cs.say(cs.smi_line())
    cs.phase_build()
    with cs.TilesDevices(lambda visible: visible[:1]):
        cs.phase_legacy(dev)
    if "--tests" not in sys.argv:
        return 0
    r = subprocess.run([sys.executable, "-m", "pytest", "-q", "--noconftest",
                        "-p", "no:cacheprovider", "-rs",
                        "tests/test_torch_cuda_legacy.py"], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    return r.returncode


if __name__ == "__main__":
    sys.exit(main())
