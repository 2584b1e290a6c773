"""Logical-axis sharding rules for params, optimizer state and
activations; a per-unit function over a leading unit axis; the shared
host thread pools of the read path.

Sharding rules (the JAX package's ``repro.parallel.sharding``, its rules
half).  Mesh axes:
  * ``model`` (tp): tensor parallel -- attention heads / ffn hidden /
    vocab / experts (EP).
  * ``data``  (dp + fsdp): batch sharding and the FSDP dimension of
    every weight matrix.
  * ``pod``   (multi-pod only): pure data parallelism across pods.

Model code never names mesh axes: it calls ``act(x, kind)``.  Here that
is the identity: without rules there is nothing to constrain, and with
rules it checks the kind and returns ``x``, because the port runs one
card (sharded execution is ROADMAP Queue 1 item 13d).  ``param_specs``
gives each parameter the JAX package's spec: the port's dotted, unstacked
names (``blocks.3.attn.wq``, ``models/convert.py``) are matched as the
reference's slash paths with the layer index dropped, and a stacked
leaf's spec loses the reference's leading ``None``.

Tile units.  The JAX package shard_maps same-signature tile units over a
device mesh (``map_tiles``) and pads ragged batches to the device count
(``map_tiles_padded``).  The port runs one card, and its unit-batched
stages are kernels with a unit axis of their own (core/backend.py), so
here the two are the same thing: ``fn`` applied to every row of the
stacked inputs, the results stacked again.  It is what the plain
versions of the unit-batched kernels are built from.  Spreading units
over several cards is not ported.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import re
from typing import Optional, Tuple

import torch


def _axes(part):
    """One dimension's axes, normalized as ``jax.sharding.PartitionSpec``
    does: an empty tuple is None, a one-name tuple its name."""
    if isinstance(part, (tuple, list)):
        if not part:
            return None
        return part[0] if len(part) == 1 else tuple(part)
    return part


class PartitionSpec(tuple):
    """Per-dimension mesh axes (None, an axis name or a tuple of names);
    a tuple, as ``jax.sharding.PartitionSpec`` is."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(_axes(p) for p in parts))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: object
    spec: PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    dp: Tuple[str, ...] = ("data",)    # batch axes (includes 'pod' if present)
    fsdp: Optional[str] = "data"       # weight-shard axis (within-pod)
    tp: Optional[str] = "model"
    tp_size: int = 1
    dp_size: int = 1


_RULES: Optional[ShardingRules] = None


def rules_for_mesh(mesh) -> ShardingRules:
    names = tuple(mesh.axis_names)
    dp = tuple(a for a in ("pod", "data") if a in names)
    dp = dp or (names[0],)
    tp = "model" if "model" in names else None
    dp_size = 1
    for a in dp:
        dp_size *= mesh.shape[a]
    return ShardingRules(
        dp=dp,
        fsdp="data" if "data" in names else None,
        tp=tp,
        tp_size=mesh.shape[tp] if tp else 1,
        dp_size=dp_size,
    )


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    global _RULES
    prev = _RULES
    _RULES = rules
    try:
        yield
    finally:
        _RULES = prev


def current_rules() -> Optional[ShardingRules]:
    return _RULES


# ------------------------------------------------------------- activations

def act(x, kind: str):
    """The activation ``x`` of ``kind``: the identity (one card has nothing
    to constrain); with rules active an unknown kind raises KeyError."""
    r = _RULES
    if r is not None:
        _ACT_SPECS[kind](r, x.shape)
    return x


def _cache_spec(r, shape):
    # (L, B, S, Hkv, Dh): heads over tp when divisible; otherwise shard
    # the head dim (contracting-dim TP); never S (the decode write would
    # cross shards)
    if r.tp and shape[3] % r.tp_size == 0:
        return P(None, r.dp, None, r.tp, None)
    if r.tp and shape[4] % r.tp_size == 0:
        return P(None, r.dp, None, None, r.tp)
    return P(None, r.dp, None, None, None)


def _cache_seqshard_spec(r, shape):
    axes = tuple(a for a in (r.fsdp, r.tp) if a)
    return P(None, None, axes, None, None)


def _state_spec(r, shape):
    # recurrent state (L, B, H/feat, ...): feature over tp when divisible
    tp = r.tp if (r.tp and shape[2] % r.tp_size == 0) else None
    return P(None, r.dp, tp, *([None] * (len(shape) - 3)))


_ACT_SPECS = {
    # (B, S, D) replicated D between blocks
    "hidden": lambda r, s: P(r.dp, *([None] * (len(s) - 1))),
    # (B, S, V) vocab-sharded logits
    "logits": lambda r, s: P(r.dp, *([None] * (len(s) - 2)), r.tp),
    # (B, S, H*, ...) head-sharded tensor
    "heads": lambda r, s: P(r.dp, None, r.tp, *([None] * (len(s) - 3))),
    # (B, S) tokens
    "tokens": lambda r, s: P(r.dp, *([None] * (len(s) - 1))),
    "cache": _cache_spec,
    "cache_seqshard": _cache_seqshard_spec,
    "state": _state_spec,
}


# ------------------------------------------------------------- params

# (pattern, spec of the rules) -- first match wins; matched against the
# reference's slash path of a parameter (``_ref_path``)
def _pp(*names):
    return re.compile("|".join(names))


_PARAM_RULES = [
    # embeddings
    (_pp(r"embedding$"), lambda r: P(r.tp, r.fsdp)),
    (_pp(r"lm_head$"), lambda r: P(r.fsdp, r.tp)),
    # attention
    (_pp(r"\bwq$", r"\bwk$", r"\bwv$"), lambda r: P(r.fsdp, r.tp)),
    (_pp(r"\bwo$"), lambda r: P(r.tp, r.fsdp)),
    (_pp(r"\bbq$", r"\bbk$", r"\bbv$"), lambda r: P(r.tp)),
    # mlp
    (_pp(r"w_gate$", r"w_up$", r"c_wk$", r"c_wr$", r"\bwr$", r"\bwg$"),
     lambda r: P(r.fsdp, r.tp)),
    (_pp(r"w_down$", r"c_wv$"), lambda r: P(r.tp, r.fsdp)),
    (_pp(r"b_up$"), lambda r: P(r.tp)),
    # moe (expert-parallel leading dim)
    (_pp(r"router$"), lambda r: P(r.fsdp, None)),
    (_pp(r"experts?/w_gate$",), lambda r: P(r.tp, r.fsdp, None)),
    # mamba
    (_pp(r"in_proj$", r"dt_proj$"), lambda r: P(r.fsdp, r.tp)),
    (_pp(r"out_proj$"), lambda r: P(r.tp, r.fsdp)),
    (_pp(r"x_proj$", r"a_log$"), lambda r: P(r.tp, None)),
    (_pp(r"conv_w$"), lambda r: P(None, r.tp)),
    (_pp(r"conv_b$", r"dt_bias$", r"d_skip$"), lambda r: P(r.tp)),
    # rwkv decay lora
    (_pp(r"w_lora_a$"), lambda r: P(r.fsdp, None)),
    (_pp(r"w_lora_b$"), lambda r: P(None, r.tp)),
]

_MOE_EXPERT = re.compile(r"(^|/)(w_gate|w_up|w_down)$")

# containers whose leaves the reference stacks over layers (groups)
_STACKED = ("blocks", "enc_blocks", "dec_blocks", "superblocks")


def _leaf_spec(path: str, ndim: int, n_stack: int, r: ShardingRules) -> P:
    # expert tensors are 3D (E, ., .): match before generic mlp rules
    if ndim - n_stack == 3 and _MOE_EXPERT.search(path):
        if path.endswith("w_down"):
            base = (r.tp, None, r.fsdp)
        else:
            base = (r.tp, r.fsdp, None)
        return P(*([None] * n_stack), *base)
    for pat, spec_of in _PARAM_RULES:
        if pat.search(path):
            base_t = tuple(spec_of(r))
            # pad/trim to actual rank after the stacked prefix
            rank = ndim - n_stack
            if len(base_t) > rank:
                base_t = base_t[:rank]
            base_t = base_t + (None,) * (rank - len(base_t))
            return P(*([None] * n_stack), *base_t)
    return P()  # replicate (norm scales, small vectors)


def _ref_path(name: str) -> str:
    """The reference's slash path of the port parameter ``name``, the
    layer (group) index dropped: ``blocks.3.attn.wq`` -> ``blocks/attn/wq``,
    ``superblocks.2.0.attn.wq`` -> ``superblocks/0/attn/wq``."""
    parts = name.split(".")
    if parts[0] in _STACKED:
        del parts[1]
    return "/".join(parts)


def param_specs(named_shapes: dict, rules: ShardingRules) -> dict:
    """Parameter name -> PartitionSpec for ``named_shapes`` (name -> a
    tensor, fake tensor or shape): the reference's spec of the same
    leaf, less the leading ``None`` of its stacked axis."""
    out = {}
    for name, leaf in named_shapes.items():
        nd = len(leaf.shape) if hasattr(leaf, "shape") else len(leaf)
        out[name] = P() if nd == 0 else \
            _leaf_spec(_ref_path(name), nd, 0, rules)
    return out


def param_shardings(named_shapes: dict, mesh) -> dict:
    rules = rules_for_mesh(mesh)
    return {n: NamedSharding(mesh, s)
            for n, s in param_specs(named_shapes, rules).items()}


# --------------------------------------------------------- tile units

DEFAULT_HOST_WORKERS = 8


def _stack(outs):
    first = outs[0]
    if isinstance(first, tuple):
        return tuple(_stack([o[k] for o in outs]) for k in range(len(first)))
    return torch.stack(outs)


def map_tiles(fn, *batched):
    """``fn`` (one unit's tensors -> a tensor or a tuple of tensors)
    over the leading unit axis of ``batched``; outputs stacked on it."""
    n = int(batched[0].shape[0])
    if n == 0:
        raise ValueError("map_tiles needs at least one unit")
    return _stack([fn(*(b[i] for b in batched)) for i in range(n)])


# one card: nothing to pad to a device-count multiple
map_tiles_padded = map_tiles


@functools.lru_cache(maxsize=8)
def host_pool(name: str, workers: int = DEFAULT_HOST_WORKERS):
    """Named, process-lifetime ThreadPoolExecutor for host-side I/O."""
    from concurrent.futures import ThreadPoolExecutor

    return ThreadPoolExecutor(max_workers=workers,
                              thread_name_prefix=f"repro-torch-{name}")


def host_map(pool, fn, items):
    """``pool.map`` that awaits every item and re-raises the first
    worker exception (in item order) on the caller's thread.  Returns
    the results in item order."""
    futures = [pool.submit(fn, it) for it in items]
    results, first_exc = [], None
    for f in futures:
        try:
            results.append(f.result())
        except BaseException as e:     # noqa: BLE001 -- re-raised below
            if first_exc is None:
                first_exc = e
            results.append(None)
    if first_exc is not None:
        raise first_exc
    return results
