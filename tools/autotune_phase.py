#!/usr/bin/env python3
"""chip_smoke's autotune parity and phase 4h (plan autotuning over the
backend arms, the rate search, the baselines) alone, on the card.

    python3 tools/autotune_phase.py [--arms] [--tests]

Builds the kernels, runs ``chip_smoke.parity_autotune`` (card bytes ==
CPU bytes of tuned plans, one table favouring the "xla" arm), times the
default monolithic plan (host codec, second call) at chip_smoke's main
sizes as phase 4 does, and calls ``chip_smoke.phase_autotune`` with
those runs: the calibration over the card's three arms, the measured
tunes (each measured candidate's arm, predicted and measured seconds,
the chosen arm, its container's ``sl_backend``, bytes == the plan set
by hand, launches of the arm's K3 / K4 only), the tuned stream, the rate
search and the baselines; each measured candidate's whole measurement
(warm-up and timed call) is printed beside the tune's lines.  ``--arms``
then times the default monolithic plan with each arm's ``cfg.backend``
at the main sizes (a first and a second synchronized call on the host
clock; ratio, bytes and header tag beside), and ``--tests`` runs
tests/test_torch_cuda_autotune.py.  Exits non-zero if a check fails.
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


def timed(dev, fn):
    """(fn(), host-clock seconds of the synchronized call)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main_runs(dev):
    """The default plan at the main sizes, host codec, as phase 4 keeps
    them for phase 4h (shape, codec, ratio, encode / decode seconds of a
    second call)."""
    import repro_torch as rt
    from repro_torch.data import synthetic

    rows = []
    for T, H, W in cs.SIZES["main"]:
        u, v = synthetic.vortex_street(T=T, H=H, W=W)
        cfg = rt.CompressionConfig(**cs.scf_meta(T, H, W))
        rt.compress(u, v, cfg, device=dev)
        (blob, stats), enc_s = timed(dev, lambda: rt.compress(u, v, cfg,
                                                              device=dev))
        _, dec_s = timed(dev, lambda: rt.decompress(blob, device=dev))
        rows.append({"shape": (T, H, W), "codec": "host",
                     "ratio": stats["ratio"], "enc_s": enc_s,
                     "dec_s": dec_s})
        cs.say(f"default plan {T}x{H}x{W}: ratio {stats['ratio']:.4f}, "
               f"encode {enc_s:.3f} s, decode {dec_s:.3f} s (second call)")
    return rows


def timed_measures():
    """Print the seconds of each measure-verify call of a tune (the
    candidate's warm-up and its timed run)."""
    from repro_torch import autotune

    orig = autotune._measure_fn

    def measure_fn(u, v, cfg, device):
        inner = orig(u, v, cfg, device)

        def measure(cand):
            out, s = timed(device, lambda: inner(cand))
            cs.say(f"measure {cand.describe()} on {u.shape}: {s:.4f} s "
                   f"(warm-up + timed run), timed run {out:.4f} s")
            return out
        return measure

    autotune._measure_fn = measure_fn


def arm_sweep(dev):
    """The default monolithic plan under each of the card's arms."""
    import repro_torch as rt
    from repro_torch import autotune
    from repro_torch.autotune.search import config_backend
    from repro_torch.data import synthetic

    for T, H, W in cs.SIZES["main"]:
        u, v = synthetic.vortex_street(T=T, H=H, W=W)
        for arm in autotune.available_backends(dev):
            cfg = rt.CompressionConfig(backend=config_backend(arm),
                                       **cs.scf_meta(T, H, W))
            _, first_s = timed(dev, lambda: rt.compress(u, v, cfg,
                                                        device=dev))
            (blob, stats), enc_s = timed(dev, lambda: rt.compress(
                u, v, cfg, device=dev))
            assert cs.sl_tag(blob) == arm, cs.sl_tag(blob)
            cs.say(f"arm {arm} {T}x{H}x{W}: encode {first_s:.4f} s first "
                   f"call, {enc_s:.4f} s second call (host clock), ratio "
                   f"{stats['ratio']:.4f}, {len(blob)} B, sl_backend {arm}")


def main() -> int:
    if not torch.cuda.is_available():
        print("autotune_phase: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cs.say(cs.smi_line())
    cs.phase_build()
    timed_measures()
    with cs.TilesDevices(lambda visible: visible[:1]):
        cs.parity_autotune(dev)
        cs.phase_autotune(dev, main_runs(dev))
        if "--arms" in sys.argv:
            arm_sweep(dev)
    if "--tests" not in sys.argv:
        return 0
    r = subprocess.run([sys.executable, "-m", "pytest", "-q", "--noconftest",
                        "-p", "no:cacheprovider", "-rs",
                        "tests/test_torch_cuda_autotune.py"], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    return r.returncode


if __name__ == "__main__":
    sys.exit(main())
