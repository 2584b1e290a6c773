"""The benchmark of ``repro_torch``: one run of one cell.

A cell (``workloads`` in ``BENCHMARK.json``) names a configuration and a
traffic mix; each is a data file found by its name:
``bench/configs/<config>.json`` (the field, its chunk length and the
compressor's settings) and ``bench/mixes/<traffic>.json`` (the
operation, the pool of chunks, the loop and how many answers the check
samples).  The mix's operation is ``bench/ops/<op>.py``: its set-up, one
call, its end-to-end values and its check.  A per-layer metric is
``bench/metrics/<name>.py``, a reader with ``read(ctx)`` that returns a
number or None.

A run: make the configuration's pool of chunks on the card, write the
containers a read mix reads, warm one call of the cell's own shape (all
of it is ``setup_s``), then call the program back to back over the pool
in the order the seed draws, for ``--seconds`` (the window ends at the
first call that finishes after it, or at the end of that pass over the
pool), then judge the answers with the plain reference
(``bench/reference``), in a sample the seed draws, and print one JSON
line.  ``--trace 1`` runs the
window under ``torch.profiler`` with the program's spans on and reports
the per-layer metrics in place of the end-to-end ones.

The program is driven through its public entry points only:
``repro_torch.core.compressor.compress`` / ``decompress`` and
``repro_torch.obs``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import random
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(Exception):
    """The run cannot start (no card, a forbidden module, no cell)."""


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (the part before the first
    dot, compared whole) is JAX's or the JAX package's."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise Refused(f"no workload named {name!r} in BENCHMARK.json")


def data_file(directory: Path, name: str) -> Path:
    """``<directory>/<name>.json``, the data file of a configuration or a
    mix."""
    path = directory / f"{name}.json"
    if not path.is_file():
        raise Refused(f"no data file {path}")
    return path


def cell_metrics(bench: dict, cell: dict, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries this cell reports: those
    whose ``workloads`` list it, else (no list) those whose end-to-end
    metric the cell reports."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])}
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell["name"] in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def load_reader(name: str, bench_dir: Path = BENCH):
    return load_module(bench_dir / "metrics" / f"{name}.py",
                       "bench_metric_").read


def load_op(name: str, bench_dir: Path = BENCH):
    """``bench/ops/<name>.py``: ``RATE``, ``setup``, ``call``,
    ``end_to_end`` and ``check``."""
    path = bench_dir / "ops" / f"{name}.py"
    if not path.is_file():
        raise Refused(f"no op file {path}")
    mod = load_module(path, "bench_op_")
    mod.NAME = name
    return mod


# ----------------------------------------------------------------------
# the cell's inputs
# ----------------------------------------------------------------------

def load_module(path: Path, prefix: str):
    """The Python file ``path`` as a module (a data-driven piece: a
    generator or a metric's reader, found by its name)."""
    name = prefix + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_pool(config: dict, mix: dict, device,
              bench_dir: Path = BENCH) -> list:
    """``mix["pool_chunks"]`` successive chunks of the configuration's
    simulation (its generator at ``field["seed"]``), made on ``device``,
    as host float32 (u, v) pairs."""
    import torch

    field = config["field"]
    gen = load_module(bench_dir / "generators" / f"{field['generator']}.py",
                      "bench_generator_")
    T, H, W = config["chunk_frames"], field["H"], field["W"]
    pool = []
    for c in range(mix["pool_chunks"]):
        u, v = gen.make(T, H, W, c * T, field["seed"], device)
        pool.append((u.cpu().numpy(), v.cpu().numpy()))
        del u, v
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return pool


def compression_config(config: dict):
    from repro_torch.core.compressor import CompressionConfig
    from repro_torch.core.tiling import TileGrid

    kw = dict(config["compressor"])
    if config.get("tiling"):
        kw["tiling"] = TileGrid(**config["tiling"])
    return CompressionConfig(**kw)


# ----------------------------------------------------------------------
# the window
# ----------------------------------------------------------------------

@dataclasses.dataclass
class Call:
    chunk: int
    seconds: float
    raw_bytes: int
    out_bytes: int = 0
    stats: dict = None
    error: str = None


def visit_order(n: int, seed: int) -> list:
    """The order in which the loop visits the pool's chunks: the seed's
    permutation.  Every seed does the same work (the chunks' verify
    rounds, and so their cost, depend on their data), in another
    order."""
    order = list(range(n))
    random.Random(int(seed)).shuffle(order)
    return order


def run_window(op, program, pool, state, cfg, seconds: float,
               device, order, end: str = "call"):
    """Closed loop, one client: the op back to back over the pool in
    ``order``, until the first call that finishes after ``seconds``
    (``end="call"``) or, with ``end="pass"``, the first call after it
    that completes a pass over the pool, so that every window does whole
    passes.  Returns (calls, answers, window seconds)."""
    from repro_torch import obs

    calls, answers = [], []
    t0 = time.perf_counter()
    i = 0
    while True:
        c = order[i % len(order)]
        raw = pool[c][0].nbytes + pool[c][1].nbytes
        a = time.perf_counter()
        try:
            with obs.span(f"bench.{op.NAME}", chunk=c):
                out, nbytes, stats = op.call(program, state, pool, c, cfg,
                                             device)
            b = time.perf_counter()
            calls.append(Call(c, b - a, raw, nbytes, stats))
            answers.append(out)
        except Exception as e:  # noqa: BLE001 - a failed call is counted
            b = time.perf_counter()
            traceback.print_exc(file=sys.stderr)
            calls.append(Call(c, b - a, raw, error=repr(e)[:500]))
            answers.append(None)
        i += 1
        if b - t0 >= seconds and (end == "call" or i % len(order) == 0):
            return calls, answers, b - t0


# ----------------------------------------------------------------------
# the check
# ----------------------------------------------------------------------

def judged_numbers(calls, judged) -> dict:
    """The numbers every op's check compares, each (value, limit, test):
    the worst value over the answers the reference judged
    (``bench/reference/judge.py``), and the calls that failed."""
    return {
        "answers_judged": (len(judged), 1, ">="),
        "failed_calls": (sum(c.error is not None for c in calls), 0, "<="),
        "shape_mismatch": (sum(not j["shape_ok"] for j in judged), 0, "<="),
        "max_err_over_eb": (max((j["max_err_over_eb"] for j in judged),
                                default=float("inf")), 1.0, "<="),
        "fc_t": (max((j["fc_t"] for j in judged), default=-1), 0, "=="),
        "fc_s": (max((j["fc_s"] for j in judged), default=-1), 0, "=="),
    }


def host_clocks() -> dict:
    """The process's CPU seconds (user, system), read around the window,
    so that standard error shows whether a slow run was short of CPU or
    spent more of it (the program's threads spinning beside its work)."""
    import resource

    r = resource.getrusage(resource.RUSAGE_SELF)
    return {"user_s": r.ru_utime, "sys_s": r.ru_stime}


def passes(value, limit, how) -> bool:
    if how == ">=":
        return value >= limit
    if how == "==":
        return value == limit
    return value <= limit


# ----------------------------------------------------------------------
# one run
# ----------------------------------------------------------------------

def prepare_env(cell: dict):
    """Caches inside the checkout at fixed paths; the run sees the first
    ``chips`` of the cards it was given, and no more."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["REPRO_JIT_CACHE"] = str(build / "repro_torch")
    os.environ["USE_FLAX"] = "0"
    chips = int(cell["chips"])
    given = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = ([c.strip() for c in given.split(",") if c.strip()]
             if given is not None else [str(k) for k in range(chips)])
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(cards[:chips])
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, root: Path = ROOT, device: str = "cuda",
        program=None) -> tuple:
    """One run; returns (result dict, check dict).  ``device="cpu"``
    (tests) skips the look for a card; ``program`` stands in for
    ``repro_torch``'s compressor module (bench/control.py)."""
    found = forbidden_modules()
    if found:
        raise Refused(f"forbidden modules loaded: {found}")
    bench = load_json(root / "BENCHMARK.json")
    bench_dir = root / "bench"
    cell = find_cell(bench, workload)
    config = load_json(data_file(bench_dir / "configs", cell["config"]))
    mix = load_json(data_file(bench_dir / "mixes", cell["traffic"]))
    op = load_op(mix["op"], bench_dir)
    if device == "cuda":
        prepare_env(cell)
    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            raise Refused("no CUDA device")
        if torch.cuda.device_count() != int(cell["chips"]):
            raise Refused(f"{torch.cuda.device_count()} CUDA devices "
                          f"visible, the cell asks for {cell['chips']}")
    from repro_torch import obs
    from repro_torch.core import compressor

    program = program or compressor
    cfg = compression_config(config)
    pool = make_pool(config, mix, device, bench_dir)
    order = visit_order(len(pool), seed)
    state = op.setup(program, pool, cfg, order, device)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    prof = None
    if trace:
        obs.enable()
        obs.reset()
        from bench import profiling
        prof = profiling.Profile(on_card)
        prof.start()
    host0 = host_clocks()
    calls, answers, window_s = run_window(op, program, pool, state, cfg,
                                          seconds, device, order,
                                          mix.get("end", "call"))
    host1 = host_clocks()
    profile = None
    if trace:
        profile = prof.stop()
        spans = obs.stage_durations()
        counters = {k: v.get("value") for k, v in obs.snapshot().items()
                    if v.get("type") == "counter"}
        obs.disable()
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                "count": torch.cuda.device_count() if on_card else 1,
                "memory_peak_bytes": max(
                    torch.cuda.max_memory_allocated(k)
                    for k in range(torch.cuda.device_count()))
                if on_card else 0}
    if on_card:
        torch.cuda.empty_cache()

    done = [c for c in calls if c.error is None]
    metrics = {}
    if not trace:
        values = {"setup_s": setup_s, **op.end_to_end(done)}
        for m in cell_metrics(bench, cell, "end_to_end"):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        dev_info["busy_s"] = profile["busy_s"]
        dev_info["window_s"] = profile["window_s"]
        ctx = {"calls": done, "spans": spans, "counters": counters,
               "profile": profile, "config": config}
        for m in cell_metrics(bench, cell, "per_layer"):
            value = load_reader(m["name"], bench_dir)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    t_check = time.perf_counter()
    checks = op.check({"pool": pool, "calls": calls, "answers": answers,
                       "config": config, "mix": mix, "seed": seed,
                       "device": device, "decompress": program.decompress})
    print(f"timing setup_s {setup_s:.3f} window_s {window_s:.3f} calls "
          f"{len(calls)} check_s {time.perf_counter() - t_check:.3f}",
          file=sys.stderr)
    print("window_host " + " ".join(
        f"{k} {host1[k] - host0[k]:.3f}" for k in host0), file=sys.stderr)
    print("calls_s " + " ".join(f"{c.chunk}:{c.seconds:.4f}" for c in calls),
          file=sys.stderr)
    correct = all(passes(*v) for v in checks.values())
    result = {"correct": bool(correct), "attempted": len(calls),
              "failed": len(calls) - len(done), "metrics": metrics,
              "device": dev_info}
    if trace:
        result["breakdown"] = {"device_ops": profile["device_ops"],
                               "idle_gaps": profile["idle_gaps"]}
    result["checks"] = {k: {"value": v[0], "limit": v[1], "test": v[2]}
                        for k, v in checks.items()}
    return result, checks


def main(argv=None, t_start: float = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result, checks = run(args.workload, args.seed, args.seconds,
                             bool(args.trace), t_start)
    except Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"refused: the run loaded {found}", file=sys.stderr)
        return 3
    for k, (value, limit, how) in checks.items():
        print(f"check {k} {value} {how} {limit}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
