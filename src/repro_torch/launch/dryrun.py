"""Dry run: trace every (arch x shape) cell's step on fake tensors and
derive its roofline (the JAX package's ``repro.launch.dryrun``).

For each runnable cell this builds the real step -- ``make_train_step``
with AdamW and micro-batching, ``model.prefill``, or ``model.decode_step``
on ``init_cache`` of the cell's KV dtype and length -- with parameters,
optimizer state, batch and cache as fake tensors on the device
(``FakeTensorMode``: shapes, dtypes and aliasing, no storage), and runs
it once under ``opcost.CostMode`` and ``FlopCounterMode``.  A prefill or
decode cell first runs its entry once at batch 1, length 2 (uncounted),
so the casts of the weights that the model holds (``Params.cast``) are
arguments of the counted call, as they are in a serving loop.

Meshes: ``card`` (the default) is the (1, 1) ("data", "model") layout of
one H100, where per-device figures are the whole step's.  ``single``
(16, 16) and ``multi`` (2, 16, 16) need a sharded trace (per-device
flops and collective bytes, as GSPMD gives the JAX package): ROADMAP
Queue 1 item 13d; until then they raise NotImplementedError before any
cell runs.  ``_fit_spec``, ``_batch_shardings`` and ``_cache_shardings``
are the input layouts the sharded trace will take.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch yi_6b]
        [--shape train_4k] [--mesh card] [--out out.json] [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback

import torch
from torch._subclasses import fake_impls
from torch._subclasses.fake_tensor import FakeTensorMode, \
    unset_fake_temporarily
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from .. import configs as C
from .. import roofline
from ..core.compressor import resolve_device
from ..launch.mesh import card_mesh
from ..models.layers import Params
from ..models.transformer import build_model
from ..opcost import CostMode
from ..parallel import sharding as shd
from ..parallel.sharding import NamedSharding, P
from ..train import optimizer as opt
from ..train.train_step import init_train_state, make_train_step

SHARDED_MESHES = ("single", "multi", "both")

# fake_tensors() patches the fake mode's private table of op
# implementations at these ops; a torch that moved it fails here, at
# import, not in a trace that would dispatch other ops than the card
_VIEW_OPS = (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default)
_FAKE_IMPLS = getattr(fake_impls, "op_implementations_dict", None)
if not isinstance(_FAKE_IMPLS, dict) \
        or not all(op in _FAKE_IMPLS for op in _VIEW_OPS):
    raise ImportError(
        f"torch {torch.__version__}: torch._subclasses.fake_impls."
        "op_implementations_dict has no entry for aten.view / "
        "aten._unsafe_view; repro_torch.launch.dryrun.fake_tensors "
        "needs it")


def refuse_sharded(what: str):
    raise NotImplementedError(
        f"{what}: a mesh of more than one device needs a sharded trace "
        "(DTensor over a fake process group), ROADMAP Queue 1 item 13d; "
        "repro_torch runs the card mesh (--mesh card)")


def _axis_size(mesh, axes):
    if axes is None:
        return 1
    if isinstance(axes, (tuple, list)):
        out = 1
        for a in axes:
            out *= mesh.shape[a]
        return out
    return mesh.shape[axes]


def _fit_spec(spec, shape, mesh):
    """Drop spec axes that do not divide the dimension (input shardings
    need exact divisibility; replication is the fallback)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, axes in zip(shape, parts):
        if axes is not None and dim % _axis_size(mesh, axes) != 0:
            axes = None
        out.append(axes)
    return P(*out)


def _batch_shardings(batch, mesh, rules):
    def spec(name, leaf):
        if name == "position_ids":                  # (3, B, S)
            return P(None, rules.dp, None)
        return P(rules.dp, *([None] * (len(leaf.shape) - 1)))

    return {k: NamedSharding(mesh, spec(k, v)) for k, v in batch.items()}


def _cache_shardings(cache, mesh, rules, seq_sharded):
    """Cache name -> NamedSharding of the cache dict ``cache``."""
    tp_size = mesh.shape[rules.tp] if rules.tp else 1

    def kv_spec(shape):
        # (L, B, S, Hkv, Dh): batch over dp, heads over tp; the head dim
        # when Hkv does not divide tp (sharding S would put the decode
        # write across shards); S over every axis for the batch-1
        # long-context cache
        if seq_sharded:
            axes = tuple(a for a in (rules.fsdp, rules.tp) if a)
            return P(None, None, axes, None, None)
        if shape[3] % tp_size == 0:
            return P(None, rules.dp, None, rules.tp, None)
        if shape[4] % tp_size == 0:
            return P(None, rules.dp, None, None, rules.tp)
        return P(None, rules.dp, None, None, None)

    def spec(name, leaf):
        if name in ("k", "v", "ek", "ev"):
            return kv_spec(leaf.shape)
        if name == "wkv":                            # (L, B, H, dk, dv)
            return P(None, rules.dp, rules.tp, None, None)
        if name in ("conv", "ssm"):                  # (G, g-1, B, ..)
            return P(None, None, rules.dp)
        if name in ("tm_x", "cm_x"):                 # (L, B, 1, D)
            return P(None, rules.dp, None, None)
        return P()                                   # length

    return {k: NamedSharding(mesh, spec(k, v)) for k, v in cache.items()}


@contextlib.contextmanager
def fake_tensors():
    """``FakeTensorMode`` whose views take ATen's strides.

    The mode computes a view's strides with PyTorch's Python reference
    (``torch._refs``), which gives size-1 dimensions other strides than
    ATen does; ``matmul``'s fold-to-``mm`` test reads those strides, so a
    fake step would dispatch ``bmm`` where the real step dispatches ``mm``.
    Here a fake view takes the strides of the same view of a meta
    tensor (ATen's)."""
    table = _FAKE_IMPLS
    saved = {op: table[op] for op in _VIEW_OPS}

    def view(fake_mode, func, a, *shape):
        with unset_fake_temporarily():
            m = torch.empty_strided(a.shape, a.stride(), dtype=a.dtype,
                                    device="meta").view(*shape)
        return a.as_strided(m.shape, m.stride(), a.storage_offset())

    table.update({op: view for op in _VIEW_OPS})
    try:
        with FakeTensorMode() as mode:
            yield mode
    finally:
        table.update(saved)


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def held_casts(model) -> list:
    """The weight casts the model holds (``Params.cast``)."""
    return [t for m in model.modules() if isinstance(m, Params)
            for _, t in m._casts.values()]


def _batch(cfg, cell, dev) -> dict:
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
            for k, v in C.input_specs(cfg, cell).items()}


def _cache(model, cfg, cell):
    if cfg.is_encoder_decoder:
        return model.init_cache(cell.global_batch, cell.cache_len,
                                enc_len=cell.enc_len, dtype=cell.kv_dtype)
    if cfg.family == "ssm":
        return model.init_cache(cell.global_batch)
    return model.init_cache(cell.global_batch, cell.cache_len,
                            dtype=cell.kv_dtype)


def _entry(model, cell, dev):
    """(the cell's inference call, its input tensors) on ``model``."""
    cfg = model.cfg
    batch = _batch(cfg, cell, dev)
    if cell.kind == "prefill":
        return (lambda: model.prefill(batch)), _tensors(batch)
    cache = _cache(model, cfg, cell)
    return (lambda: model.decode_step(batch, cache)), \
        _tensors((batch, cache))


def make_step(model, cell, dev, dp_size: int = 1):
    """(the cell's step as a call without arguments, the tensors it holds
    as arguments) on ``model``: a train step (AdamW in the config's state
    dtype, micro-batches never below one example per data-parallel
    shard) returns (parameters, optimizer state, metrics), as the JAX
    package's donated step does; prefill and decode return (logits,
    cache).  Works on real and on fake tensors; inputs are zeros."""
    params = list(model.parameters())
    if cell.kind == "train":
        cfg = model.cfg
        ocfg = opt.AdamWConfig(state_dtype=cfg.opt_state_dtype)
        mb = max(min(cell.microbatches, cell.global_batch // dp_size), 1)
        step = make_train_step(model, ocfg, mb)
        state = init_train_state(model, ocfg)
        batch = _batch(cfg, cell, dev)

        def train():
            new_state, metrics = step(state, batch)
            return dict(model.named_parameters()), new_state, metrics

        return train, params + _tensors((state, batch))
    # warm the held weight casts at batch 1, length 2 (uncounted)
    tiny = dataclasses.replace(cell, global_batch=1, seq_len=2, dec_len=2,
                               cache_len=2, enc_len=2)
    with torch.no_grad():
        _entry(model, tiny, dev)[0]()
    fn, inputs = _entry(model, cell, dev)

    def infer():
        with torch.no_grad():
            return fn()

    return infer, params + held_casts(model) + inputs


def trace(fn):
    """(OpCost, FlopCounterMode's total, outputs) of one call of ``fn``."""
    with FlopCounterMode(display=False) as fc, CostMode() as cm:
        out = fn()
    return cm.cost, fc.get_total_flops(), out


def lower_cell(arch_mod, shape_name, mesh, mesh_name, device=None):
    """The dry-run row of one cell on ``mesh`` (the card mesh), traced on
    fake tensors on ``device`` (None: the CUDA device)."""
    cfg = arch_mod.CONFIG
    cell = arch_mod.CELLS[shape_name]
    arch = cfg.name
    if cell.skip:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skip", "reason": cell.skip}
    if mesh.size > 1:
        refuse_sharded(f"mesh {mesh_name} {mesh.axis_sizes}")
    dev = resolve_device(device)
    rules = shd.rules_for_mesh(mesh)

    t0 = time.perf_counter()
    with fake_tensors(), shd.use_rules(rules):
        model = build_model(cfg, device=dev)
        fn, arguments = make_step(model, cell, dev, rules.dp_size)
        cost, raw_flops, out = trace(fn)
        memory = roofline.memory_report(cost, arguments, _tensors(out))
        workload = roofline.workload_bytes(cost, arguments, _tensors(out))
    t_trace = time.perf_counter() - t0

    rl = roofline.analyze(cost, memory, raw_flops, arch, shape_name,
                          mesh_name, mesh.size, cfg, cell, workload)
    row = rl.row()
    row.update({"status": "ok", "kind": cell.kind,
                "trace_s": round(t_trace, 1)})
    mem = memory["resident_bytes"]
    print(
        f"[dryrun] {arch:24s} {shape_name:12s} {mesh_name:6s} OK  "
        f"trace={t_trace:6.1f}s  flops/dev={rl.flops_per_device:.3e}  "
        f"eager_bytes/dev={rl.bytes_per_device:.3e}  "
        f"workload_bytes/dev={rl.workload_bytes_per_device:.3e}  "
        f"resident={mem / 2**30:.2f}GiB  bottleneck={rl.bottleneck} "
        f"(workload: {rl.workload_bottleneck})",
        flush=True,
    )
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="single arch module name")
    ap.add_argument("--shape", default=None, choices=list(C.SHAPE_TABLE))
    ap.add_argument("--mesh", default="card",
                    choices=["card", *SHARDED_MESHES])
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="device of the fake tensors (default: the CUDA "
                         "device)")
    args = ap.parse_args(argv)
    if args.mesh in SHARDED_MESHES:
        refuse_sharded(f"--mesh {args.mesh}")

    archs = [args.arch] if args.arch else C.ARCHS
    shapes = [args.shape] if args.shape else list(C.SHAPE_TABLE)
    mesh = card_mesh()

    rows = []
    failures = 0
    for arch_name in archs:
        mod = C.get(arch_name)
        for shape_name in shapes:
            try:
                rows.append(lower_cell(mod, shape_name, mesh, args.mesh,
                                       args.device))
            except Exception:
                failures += 1
                print(f"[dryrun] {arch_name} {shape_name} {args.mesh} "
                      f"FAILED", flush=True)
                traceback.print_exc()
                rows.append({
                    "arch": arch_name, "shape": shape_name,
                    "mesh": args.mesh, "status": "fail",
                    "error": traceback.format_exc()[-2000:],
                })
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1, default=str)
        print(f"[dryrun] wrote {args.out}")
    ok = sum(1 for r in rows if r.get("status") == "ok")
    skip = sum(1 for r in rows if r.get("status") == "skip")
    print(f"[dryrun] {ok} ok, {skip} skip, {failures} fail")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
