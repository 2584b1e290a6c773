"""Run one cell of the benchmark of ``repro_torch`` (BENCHMARK.json):

    python bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's CUDA cards.
Prints one JSON line (the last of standard output); see bench/harness.py.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root in place of this directory, so that no file here
# shadows a module of the standard library
sys.path[0] = str(Path(__file__).resolve().parents[1])

from bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
