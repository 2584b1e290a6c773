#!/usr/bin/env python3
"""K6, the card's Huffman decode of the device codec's symbol sections,
at the read cell's size, on the card.

    python3 tools/huffman_phase.py [--tests] [--out FILE]

Builds the kernels, makes the first 64x512x512 chunk of the
fs512-device configuration on the card (bench/configs, bench/generators)
and compresses it with the device codec.  For both Huffman sections of
that container: K6 == the host decode == the plain version (symbols and
status); K6's time by CUDA events over device-resident inputs; the card
route (``entropy.decode_on``: upload, K6, symbols back to the host) by
the host clock; the plain version on the card; the host
``encode.huffman_decode``; the compulsory-bytes bound (the bitstream read
once and the symbols written once at 3.35 TB/s); and each pass's device
time under torch.profiler.  Then whole ``decompress`` calls of the
container with spans on (the decode.* spans a call).  Prints one JSON
line (also written to ``--out``).  ``--tests`` then runs
tests/test_torch_cuda_huffman.py.  Exits non-zero if a check fails.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from bench import harness  # noqa: E402
from huffman_cases import huff_sections, padded, tables  # noqa: E402


def host_ms(fn, reps: int) -> list:
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def stream_row(dev, name, ln, data, n):
    from repro_torch.core import encode, entropy
    from repro_torch.kernels.entropy import ops, ref

    ln32 = np.asarray(ln, np.int32)
    tab, fill = tables(ln32)
    stream = padded(data).to(dev)
    tab_d = torch.as_tensor(tab).to(dev)
    nbits = 8 * len(data)

    def k6():
        return ops.huffman_decode(stream, tab_d, nbits, n, fill)

    sym, status = k6()
    r_sym, r_status = ref.huffman_decode(stream, tab_d, nbits, n, fill)
    t0 = time.perf_counter()
    host = encode.huffman_decode(ln32, data, n)
    host_s = time.perf_counter() - t0
    route = entropy.decode_on(dev, ln32, data, n)
    ok = (torch.equal(sym, r_sym) and torch.equal(status, r_status)
          and np.array_equal(sym.cpu().numpy(), host)
          and np.array_equal(route, host))
    assert ok, f"{name}: K6 differs from the host or the plain decode"
    k6_ms = cs.time_ms(k6, 20)
    plain_ms = cs.time_ms(
        lambda: ref.huffman_decode(stream, tab_d, nbits, n, fill), 2)
    route_ms = host_ms(lambda: entropy.decode_on(dev, ln32, data, n), 5)
    _, _, rows = cs.device_profile(k6)
    bound_bytes = len(data) + n
    return {
        "section": name, "symbols": n, "bits": nbits,
        "bits_per_symbol": nbits / n, "status": status.tolist(),
        "k6_ms": k6_ms, "plain_ms": plain_ms,
        "route_ms_median": statistics.median(route_ms), "route_ms": route_ms,
        "host_ms": host_s * 1e3,
        "bound_bytes": bound_bytes,
        "bound_ms": bound_bytes / cs.HBM_BYTES_PER_S * 1e3,
        "roofline_pct": 100 * bound_bytes / cs.HBM_BYTES_PER_S * 1e3 / k6_ms,
        "passes": [(k, round(ms, 5), c) for k, ms, c in rows],
    }


def read_calls(dev, blob, reps=3):
    import repro_torch
    from repro_torch import obs

    repro_torch.decompress(blob, device=dev)          # warm
    out = []
    for _ in range(reps):
        obs.reset()
        obs.enable()
        t0 = time.perf_counter()
        repro_torch.decompress(blob, device=dev)
        wall = time.perf_counter() - t0
        obs.disable()
        spans = {k: round(v["sum_s"] * 1e3, 3)
                 for k, v in obs.stage_durations("decode.").items()}
        out.append({"call_ms": round(wall * 1e3, 3), "spans_ms": spans})
    obs.reset()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tests", action="store_true")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("huffman_phase: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.kernels.entropy import kernel as k6

    dev = torch.device("cuda")
    smi = cs.smi_line()
    cs.say(smi, torch.__version__)
    cs.phase_build()
    config = harness.load_json(ROOT / "bench" / "configs" / "fs512-device.json")
    (u, v), = harness.make_pool(config, {"pool_chunks": 1}, dev)
    blob, stats = repro_torch.compress(u, v, harness.compression_config(config),
                                       device=dev)
    cs.say(f"container: {len(blob)} B, ratio {stats['ratio']:.5f}")
    rows = [stream_row(dev, *sec) for sec in huff_sections(blob)]
    for r in rows:
        cs.say(json.dumps({k: r[k] for k in r if k != "passes"}))
    launches0 = k6.huffman_decode.launches
    calls = read_calls(dev, blob)
    launches = k6.huffman_decode.launches - launches0
    out = {"card": smi, "torch": torch.__version__, "streams": rows,
           "read_calls": calls, "k6_launches_in_reads": launches}
    line = json.dumps(out)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    cs.say(line)
    if not args.tests:
        return 0
    r = subprocess.run([sys.executable, "-m", "pytest", "-q", "--noconftest",
                        "-p", "no:cacheprovider", "-rs",
                        "tests/test_torch_cuda_huffman.py"], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    return r.returncode


if __name__ == "__main__":
    sys.exit(main())
