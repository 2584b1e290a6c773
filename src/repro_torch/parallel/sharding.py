"""Logical-axis sharding rules for params, optimizer state and
activations; their placement on a ``torch.distributed`` device mesh; a
per-unit function over a leading unit axis; the shared host thread pools
of the read path.

Sharding rules (the JAX package's ``repro.parallel.sharding``, its rules
half).  Mesh axes:
  * ``model`` (tp): tensor parallel -- attention heads / ffn hidden /
    vocab / experts (EP).
  * ``data``  (dp + fsdp): batch sharding and the FSDP dimension of
    every weight matrix.
  * ``pod``   (multi-pod only): pure data parallelism across pods.

Model code never names mesh axes: it calls ``act(x, kind)``.  On a plain
tensor that is the identity (one card has nothing to constrain; with
rules active it still checks the kind).  On a DTensor, with rules
active, it redistributes ``x`` to the kind's spec: the reference's
``with_sharding_constraint``.  ``param_specs`` gives each parameter the
JAX package's spec: the port's dotted, unstacked names
(``blocks.3.attn.wq``, ``models/convert.py``) are matched as the
reference's slash paths with the layer index dropped, and a stacked
leaf's spec loses the reference's leading ``None``.

Placement.  ``placements(spec, mesh)`` turns a spec into one DTensor
placement per mesh dimension; ``distribute_params`` makes every
parameter of a model a DTensor with its spec's placements.  GSPMD pads
a dimension that an axis does not divide; DTensor cannot view such a
dimension, so every placement here first drops the axes that do not
divide (``fit_spec``, the dry run's input rule).  ``on_shards`` runs a
function on each device's shards (attention, the Mamba and RWKV scans,
MoE's routing and experts, the embedding lookup): computations that
never cross a shard, which DTensor would otherwise dispatch op by op.

Tile units.  The JAX package shard_maps same-signature tile units over a
device mesh (``map_tiles``) and pads ragged batches to the device count
(``map_tiles_padded``).  The port runs one card, and its unit-batched
stages are kernels with a unit axis of their own (core/backend.py), so
here the two are the same thing: ``fn`` applied to every row of the
stacked inputs, the results stacked again.  It is what the plain
versions of the unit-batched kernels are built from.  Spreading units
over several cards is not ported (ROADMAP Queue 1 item 13e).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import re
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, \
    distribute_tensor


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


# ------------------------------------------------------------- placement

def mesh_sizes(mesh) -> dict:
    """Axis name -> size of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def _axis_tuple(axes) -> tuple:
    if axes is None:
        return ()
    return tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)


def fit_spec(spec, shape, sizes: dict) -> PartitionSpec:
    """Drop spec axes that do not divide the dimension (input shardings
    need exact divisibility; replication is the fallback).  ``sizes``:
    axis name -> size (``mesh_sizes`` of a DeviceMesh, ``Mesh.shape``)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, axes in zip(shape, parts):
        n = 1
        for a in _axis_tuple(axes):
            n *= sizes[a]
        out.append(None if axes is not None and dim % n else axes)
    return P(*out)


def placements(spec, mesh) -> tuple:
    """One placement per mesh dimension for ``spec``: ``Shard(d)`` on the
    axes that shard dimension d, ``Replicate()`` elsewhere.  A dimension
    on several axes (``('pod', 'data')``) is split over them in mesh
    order, the reference's major-to-minor order; axes named out of mesh
    order, twice, or not in the mesh raise ValueError."""
    names = _axis_names(mesh)
    out = [Replicate()] * len(names)
    used = set()
    for d, axes in enumerate(spec):
        idx = []
        for a in _axis_tuple(axes):
            if a not in names:
                raise ValueError(f"axis {a!r} of {spec} is not in the mesh "
                                 f"{names}")
            if a in used:
                raise ValueError(f"axis {a!r} appears twice in {spec}")
            used.add(a)
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(
                f"dimension {d} of {spec} names its axes out of mesh order "
                f"{names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def place(x: torch.Tensor, spec, mesh):
    """``x``, the same value on every rank, as a DTensor on ``mesh`` with
    ``spec`` (fitted): each rank keeps its slice, nothing moves."""
    if x.device.type != mesh.device_type:
        x = x.to(mesh.device_type)
    return distribute_tensor(x, mesh, placements(fit_spec(
        spec, x.shape, mesh_sizes(mesh)), mesh),
                             src_data_rank=None)


def distribute_params(model, mesh, rules: Optional[ShardingRules] = None):
    """Make every parameter of ``model`` a DTensor on the device mesh
    ``mesh`` with the placements of its ``param_specs`` spec (fitted), in
    place; the values are the rank's own copy (every rank built the same
    model from the same seed), so nothing is sent.  Returns ``model``."""
    rules = rules or rules_for_mesh(mesh)
    named = dict(model.named_parameters())
    specs = param_specs(named, rules)
    for name, p in named.items():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner)
        mod._parameters[leaf] = torch.nn.Parameter(
            place(p.detach(), specs[name], mesh),
            requires_grad=p.requires_grad)
        if hasattr(mod, "_casts"):
            mod._casts = {}
    return model


def spec_of(x) -> PartitionSpec:
    """The PartitionSpec of the DTensor ``x``'s placements."""
    dims = {}
    for name, p in zip(x.device_mesh.mesh_dim_names, x.placements):
        if p.is_shard():
            dims.setdefault(p.dim, []).append(name)
    return P(*(tuple(dims[d]) if d in dims else None
               for d in range(max(dims, default=-1) + 1)))


def is_sharded(*xs) -> bool:
    return any(isinstance(x, DTensor) for x in xs)


def on_shards(fn, args, in_specs, out_specs, partial=None):
    """``fn`` on each device's shards of ``args``, for a computation that
    never crosses a shard (every element of an output shard depends only
    on the same rank's input shards).

    Without a DTensor among ``args`` this is ``fn(*args)``.  Otherwise
    each DTensor argument is redistributed to its ``in_specs`` entry
    (fitted; None: the argument passes through as it is, e.g. a
    non-tensor), ``fn`` runs on the local tensors, and each output is
    a DTensor with its ``out_specs`` entry (an int: the fitted spec of
    that argument), a partial sum over the axes ``partial[i]`` names for
    output i.  On an axis where some argument or output is split, an
    argument that is replicated there gets its gradient as a partial sum
    (each rank's shard of the work contributes its part)."""
    mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)),
                None)
    if mesh is None:
        return fn(*args)
    if _RULES is None:
        raise ValueError("on_shards: DTensor arguments need active sharding "
                         "rules (parallel.sharding.use_rules)")
    names = _axis_names(mesh)
    partial = partial or {}
    fitted = [None if spec is None or not isinstance(a, torch.Tensor)
              else fit_spec(spec, a.shape, mesh_sizes(mesh))
              for a, spec in zip(args, in_specs)]
    out_specs = [fitted[s] if isinstance(s, int) else s for s in out_specs]
    in_pl = [None if f is None else placements(f, mesh) for f in fitted]
    split = set()
    for pl in in_pl:
        split.update(i for i, p in enumerate(pl or ()) if p.is_shard())
    for i, spec in enumerate(out_specs):
        split.update(names.index(a) for a in partial.get(i, ()))
        split.update(names.index(a) for axes in spec
                     for a in _axis_tuple(axes))
    local = []
    for a, pl in zip(args, in_pl):
        if pl is None:
            local.append(a.to_local() if isinstance(a, DTensor) else a)
            continue
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * len(names),
                                   run_check=False)
        if tuple(a.placements) != pl:
            a = a.redistribute(mesh, pl)
        grad = [Partial() if i in split and p.is_replicate() else p
                for i, p in enumerate(pl)]
        local.append(a.to_local(grad_placements=grad))
    outs = fn(*local)
    single = not isinstance(outs, tuple)
    outs = (outs,) if single else outs
    sizes = mesh_sizes(mesh)
    wrapped = []
    for i, (o, spec) in enumerate(zip(outs, out_specs)):
        o = o.contiguous()     # the DTensor is described as contiguous
        pl = list(placements(spec, mesh))
        for a in partial.get(i, ()):
            pl[names.index(a)] = Partial()
        shape = list(o.shape)
        for j, p in enumerate(pl):
            if p.is_shard():
                shape[p.dim] *= sizes[names[j]]
        wrapped.append(DTensor.from_local(o, mesh, pl, run_check=False,
                                          shape=torch.Size(shape),
                                          stride=_contiguous(shape)))
    return wrapped[0] if single else tuple(wrapped)


def _contiguous(shape) -> tuple:
    out, n = [], 1
    for s in reversed(shape):
        out.append(n)
        n *= s
    return tuple(reversed(out))


def gather_fsdp(w):
    """The DTensor parameter (or its cast) ``w`` replicated over the
    active rules' FSDP axis, its tensor-parallel sharding kept."""
    r = _RULES
    names = _axis_names(w.device_mesh)
    if r is None or r.fsdp not in names:
        return w
    i = names.index(r.fsdp)
    if not w.placements[i].is_shard():
        return w
    pl = list(w.placements)
    pl[i] = Replicate()
    return w.redistribute(w.device_mesh, pl)


def unflatten(x, dim: int, sizes):
    """``x`` with dimension ``dim`` split into ``sizes``.  A DTensor
    sharded on that dimension whose first new size the shards do not
    divide is first replicated there (DTensor cannot view it)."""
    dim = dim % x.ndim
    shape = (*x.shape[:dim], *sizes, *x.shape[dim + 1:])
    if isinstance(x, DTensor):
        n = 1
        for p, m in zip(x.placements, x.device_mesh.shape):
            if p.is_shard(dim):
                n *= m
        if sizes[0] % n:
            pl = [Replicate() if p.is_shard(dim) else p
                  for p in x.placements]
            x = x.redistribute(x.device_mesh, pl)
    return x.reshape(shape)


# ------------------------------------------------------------- activations

def spec(kind: str, shape) -> Optional[PartitionSpec]:
    """The active rules' spec of an activation of ``kind`` and ``shape``
    (None without rules)."""
    return None if _RULES is None else _ACT_SPECS[kind](_RULES, shape)


def act(x, kind: str):
    """The activation ``x`` of ``kind``.  A plain tensor is returned as it
    is (with rules active an unknown kind raises KeyError); a DTensor,
    with rules active, is redistributed to the kind's spec (fitted), and
    so is its gradient in the backward pass, as JAX's
    ``with_sharding_constraint`` constrains the cotangent too (a
    gradient that would arrive as a partial sum is reduced here, where
    the forward's tensor-parallel output was)."""
    r = _RULES
    if r is not None:
        want = _ACT_SPECS[kind](r, x.shape)
        if isinstance(x, DTensor):
            mesh = x.device_mesh
            pl = placements(fit_spec(want, x.shape, mesh_sizes(mesh)),
                            mesh)
            if tuple(x.placements) != pl:
                x = x.redistribute(mesh, pl)
            return hold(x)
    return x


def hold(x):
    """``x``; a DTensor's gradient is placed as ``x`` in the backward pass
    (before it reaches the op that made ``x``)."""
    if isinstance(x, DTensor) and x.requires_grad \
            and torch.is_grad_enabled():
        return DTensor.from_local(x.to_local(), x.device_mesh, x.placements,
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())
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
