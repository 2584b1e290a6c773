"""Cost of one eager call from its aten op stream (the counterpart of the
JAX package's ``repro.hlocost``).

The JAX package walks the optimized HLO of a jitted step.  The port has
no HLO: ``CostMode`` is a ``TorchDispatchMode`` that sees every aten op
one call dispatches (after autograd and the composite decompositions:
``einsum`` and ``matmul`` arrive as ``bmm`` / ``mm`` and views), on real
tensors or on fake ones (``FakeTensorMode``: nothing is allocated), the
backward pass and ``torch.utils.checkpoint``'s recomputed forwards
included.  It adds up, into an ``OpCost`` with ``HloCost``'s fields
(``bytes`` named ``eager_bytes`` here, for what it counts):

  * flops -- a dot (mm, bmm, addmm, baddbmm, addbmm, dot, mv, addmv)
    costs 2 * |result| * K, every other op that is not a view or a
    metadata op 1 flop per output element;
  * eager_bytes -- each such op's tensor inputs plus its outputs: the
    port's eager, unfused traffic (every op reads its inputs from and writes
    its output to device memory), not XLA's fusion-aware figure.  Views,
    ``detach`` and metadata ops cost 0; a gather or an index read costs
    twice its window (the output), a scatter, ``index_copy_`` or
    ``index_put_`` twice its update; ``copy_`` / ``fill_`` / ``zero_`` do
    not read their destination;
  * copy_flops -- the part of ``flops`` that ``clone`` takes: the copies
    eager makes where a reshape cannot be a view (``matmul`` / ``einsum``
    folding a strided operand into ``bmm``'s batch), ``contiguous`` and
    ``clone`` (one layout of the same work: a shard holding one KV head
    folds without the copy its whole tensor needs);
  * nondot_flops / flops_adjusted -- the structured non-dot ops re-priced
    with the JAX package's ``NONDOT_FLOP_WEIGHTS`` (same keys, same
    weights): gathers and scatters on the elements they move, a gather
    or scatter through a one-element index as the dynamic slice or
    dynamic update slice it is, reductions, windowed passes (cumsum) and
    sorts on their input;
  * collective_bytes / coll_breakdown -- the operand bytes of the
    ``_c10d_functional`` / ``c10d`` collectives and DTensor's
    ``_dtensor.shard_dim_alltoall`` (0 on one card), by kind, and by kind
    and process group (``coll_groups``: a mesh axis's group name);
  * loop_info -- empty: eager runs every iteration of a loop, so every
    op is already counted as often as it runs and there is no trip count
    to recover;
  * peak_bytes -- the most bytes of storages the call allocated that were
    alive at once (an op output that aliases none of its inputs is a new
    storage; it is freed when its last tensor dies), and the storages
    the call wrote in place (``written``), for ``roofline.memory_report``;
  * read / written -- per storage, the bytes the call's ops read from it
    (a gather: its window) and wrote into it in place (a scatter: its
    update), for ``roofline.workload_bytes``: what the step must move
    whatever its ops, unlike ``eager_bytes``.

Sharded steps (DTensor operands on a device mesh): the mode does not
count an op on DTensors (it returns ``NotImplemented``, and DTensor's own
dispatch runs); it counts what that dispatch runs on this rank -- the
local shards' ops and the collectives of every redistribution -- with
their local sizes, so every figure is per device.  The ops DTensor's
sharding propagation runs on fake copies of the operands, to learn an
output's shape, are bookkeeping and are not counted.
"""
from __future__ import annotations

import collections
import dataclasses
import sys
from typing import Dict, List, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

NONDOT_FLOP_WEIGHTS = {
    "gather": 4.0,              # address compute + clamp per gathered elem
    "scatter": 6.0,             # address + combine per update elem
    "dynamic-slice": 2.0,
    "dynamic-update-slice": 2.0,
    "reduce": 2.0,              # histogram/sum trees: combine + route
    "reduce-window": 8.0,       # prefix-sum style windowed passes
    "select-and-scatter": 8.0,
    "sort": 16.0,               # ~log2(n) compare-exchange passes
}

# dot name -> (the index of its left operand, the operand's contracted dim)
_DOTS = {"mm": (0, 1), "bmm": (0, 2), "addmm": (1, 1), "baddbmm": (1, 2),
         "addbmm": (1, 2), "dot": (0, 0), "vdot": (0, 0), "mv": (0, 1),
         "addmv": (1, 1)}

# ops that move no data: allocation, metadata, aliasing
_FREE = {"_unsafe_view", "_reshape_alias", "empty", "empty_like",
         "empty_strided", "new_empty", "new_empty_strided", "lift_fresh",
         "detach", "alias", "resize_", "set_", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset", "is_same_size", "wait_tensor",
         "_local_scalar_dense"}

# ops that write their destination without reading it
_WRITE_ONLY = {"copy_", "fill_", "zero_"}

_GATHER = {"gather", "index_select", "index", "_unsafe_index", "take"}
_SCATTER = {"scatter", "scatter_", "scatter_add", "scatter_add_",
            "scatter_reduce", "scatter_reduce_", "index_put", "index_put_",
            "_index_put_impl_", "index_copy", "index_copy_", "index_add",
            "index_add_", "masked_scatter", "masked_scatter_"}
# gathers / scatters along one dim through an index tensor: a one-element
# index reads / writes a slab at a runtime offset (XLA's dynamic slices)
_SLAB = {"index_select": "dynamic-slice", "index_copy": "dynamic-update-slice",
         "index_copy_": "dynamic-update-slice"}
_REDUCE = {"sum", "mean", "amax", "amin", "prod", "argmax", "argmin", "var",
           "var_mean", "std", "std_mean", "any", "all", "logsumexp", "norm",
           "linalg_vector_norm", "nansum", "count_nonzero", "_softmax",
           "_log_softmax", "_softmax_backward_data",
           "_log_softmax_backward_data"}
_REDUCE_OVERLOADS = {"max": ("default", "dim", "dim_max"),
                     "min": ("default", "dim", "dim_min")}
_WINDOW = {"cumsum", "cumsum_", "cumprod", "cumprod_", "logcumsumexp",
           "cummax", "cummin", "_cummax_helper", "_cummin_helper"}
_SORT = {"sort", "topk", "kthvalue"}

_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d", "_dtensor")
# DTensor's sharding propagation (it runs each new op once on fake copies
# of its operands, inside any active mode)
_PROPAGATION = "_sharding_prop.py"

_UPDATE_ARGS = ("src", "source", "values")


@dataclasses.dataclass
class OpCost:
    flops: float = 0.0           # raw: dots + 1 flop/elem elsewhere
    eager_bytes: float = 0.0
    collective_bytes: float = 0.0
    coll_breakdown: Dict[str, float] = dataclasses.field(default_factory=dict)
    # (kind, process group name) -> bytes
    coll_groups: Dict[Tuple[str, str], float] = dataclasses.field(
        default_factory=dict)
    loop_info: List[Tuple[str, int]] = dataclasses.field(default_factory=list)
    nondot_flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    flops_adjusted: float = 0.0
    dot_flops: float = 0.0
    copy_flops: float = 0.0
    op_counts: Dict[str, int] = dataclasses.field(
        default_factory=collections.Counter)
    peak_bytes: int = 0
    # storage key -> bytes the ops read from it / wrote into it in place
    read: Dict[int, int] = dataclasses.field(
        default_factory=collections.Counter)
    written: Dict[int, int] = dataclasses.field(
        default_factory=collections.Counter)


def storage_key(t: torch.Tensor) -> int:
    """Identity of ``t``'s storage (its StorageImpl), for real and fake
    tensors alike."""
    return t.untyped_storage()._cdata


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements ``t`` addresses (an expanded, stride-0
    dim reads its elements once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0 or size == 0:
            n *= size
    return n * t.element_size()


def _named_args(func, args, kwargs) -> dict:
    names = [a.name for a in func._schema.arguments]
    out = dict(zip(names, args))
    out.update(kwargs)
    return out


def _nondot_key(name: str, overload: str, named):
    if name in _GATHER or name in _SCATTER:
        index = named().get("index")
        if name in _SLAB and isinstance(index, torch.Tensor) \
                and index.numel() == 1:
            return _SLAB[name]
        return "gather" if name in _GATHER else "scatter"
    if name in _REDUCE or overload in _REDUCE_OVERLOADS.get(name, ()):
        return "reduce"
    if name in _WINDOW:
        return "reduce-window"
    if name in _SORT:
        return "sort"
    return None


def _in_propagation(depth: int = 48) -> bool:
    """Whether DTensor's sharding propagation is on the Python stack."""
    f = sys._getframe(2)
    while f is not None and depth:
        if f.f_code.co_filename.endswith(_PROPAGATION):
            return True
        f = f.f_back
        depth -= 1
    return False


def _update(named: dict):
    for key in _UPDATE_ARGS:
        val = named.get(key)
        if isinstance(val, torch.Tensor):
            return val
    return None


class CostMode(TorchDispatchMode):
    """Count the ops one call dispatches (see the module docstring).

        with CostMode() as cm:
            out = step(...)
        cm.cost  # OpCost

    Storages that exist before the mode is entered are never counted as
    the call's allocations."""

    def __init__(self):
        super().__init__()
        self.cost = OpCost()
        self._live: Dict[int, tuple] = {}   # key -> (weak ref, bytes)
        self._live_bytes = 0
        self._sharded = False               # a DTensor op was seen

    # -- memory ---------------------------------------------------------

    def _allocated(self, t: torch.Tensor):
        from torch.multiprocessing.reductions import StorageWeakRef

        st = t.untyped_storage()
        n = st.nbytes()
        c = self.cost
        if self._live_bytes + n > c.peak_bytes:
            # the running total still holds freed storages: drop them
            # before a new peak is recorded
            for key, (ref, nb) in list(self._live.items()):
                if ref.expired():
                    del self._live[key]
                    self._live_bytes -= nb
        old = self._live.pop(st._cdata, None)
        if old is not None:              # an address reused after a free
            self._live_bytes -= old[1]
        self._live[st._cdata] = (StorageWeakRef(st), n)
        self._live_bytes += n
        c.peak_bytes = max(c.peak_bytes, self._live_bytes)

    # -- dispatch -------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            self._sharded = True
            return NotImplemented          # counted as the shards' ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not (self._sharded and _in_propagation()):
            self._charge(func, args, kwargs, out)
        return out

    def _charge(self, func, args, kwargs, out):
        c = self.cost
        if func.namespace == "prim":       # metadata (prim.device)
            return
        name = func._opname
        overload = func._overloadname
        c.op_counts[f"{func.namespace}.{name}.{overload}"] += 1
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        in_keys = {storage_key(t) for t in ins}
        for t in outs:
            if storage_key(t) not in in_keys:
                self._allocated(t)
        dests = []
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                val = args[i] if i < len(args) else kwargs.get(a.name)
                dests += _tensors(val)
        for t in dests:       # marked written even where no bytes move
            c.written[storage_key(t)] += 0

        if func.namespace in _COLLECTIVE_NS:
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                b = float(sum(_nbytes(t) for t in ins))
                c.collective_bytes += b
                c.coll_breakdown[kind] = c.coll_breakdown.get(kind, 0.0) + b
                key = (kind, str(_named_args(func, args, kwargs)
                                 .get("group_name", "")))
                c.coll_groups[key] = c.coll_groups.get(key, 0.0) + b
            return
        if func.is_view or name in _FREE:
            return

        out_elems = sum(t.numel() for t in outs)
        if name in _DOTS:
            lhs, dim = _DOTS[name]
            k = args[lhs].numel() if name in ("dot", "vdot") \
                else args[lhs].shape[dim]
            f = 2.0 * out_elems * k
            c.flops += f
            c.dot_flops += f
        else:
            c.flops += out_elems
            if name == "clone":
                c.copy_flops += out_elems

        memo = {}

        def named():
            if not memo:
                memo.update(_named_args(func, args, kwargs))
            return memo

        key = _nondot_key(name, overload, named)
        window = None                    # a gather's read of each input
        wrote = None                     # a scatter's write into its dest
        if key in ("gather", "dynamic-slice"):
            window = sum(_nbytes(t) for t in outs)
            c.eager_bytes += 2 * window
            charge = out_elems
        elif key in ("scatter", "dynamic-update-slice"):
            upd = _update(named())
            if upd is None:              # scatter of a scalar value
                upd = named()["index"]
            c.eager_bytes += 2 * _nbytes(upd)
            charge = upd.numel()
            wrote = _nbytes(upd)
        else:
            if name in _WRITE_ONLY:
                ins = ins[1:]
            c.eager_bytes += sum(_nbytes(t) for t in ins) \
                + sum(_nbytes(t) for t in outs)
            charge = ins[0].numel() if ins else out_elems
            if name == "embedding":      # reads its rows, not the table
                window = sum(_nbytes(t) for t in outs)
        for t in ins:
            if wrote is not None and any(t is d for d in dests):
                continue                 # a scatter does not read its dest
            n = _nbytes(t)
            c.read[storage_key(t)] += n if window is None else min(n, window)
        for t in dests:
            c.written[storage_key(t)] += _nbytes(t) if wrote is None \
                else wrote
        if key is not None:
            full = NONDOT_FLOP_WEIGHTS[key] * charge
            c.nondot_flops[key] = c.nondot_flops.get(key, 0.0) + full
            c.flops_adjusted += max(full - out_elems, 0.0)

    def __exit__(self, *exc):
        self.cost.flops_adjusted += self.cost.flops
        return super().__exit__(*exc)
