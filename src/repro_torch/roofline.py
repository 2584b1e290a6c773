"""Roofline terms of a dry-run step (the JAX package's ``repro.roofline``),
for one NVIDIA H100.

Three terms per (arch, shape, mesh), in seconds:

    compute    = flops_per_device / PEAK_FLOPS   (989 TFLOP/s bf16 dense)
    memory     = bytes_per_device / HBM_BW       (3.35 TB/s HBM3)
    collective = collective_bytes_per_device / LINK_BW   (450 GB/s NVLink,
                                                          one direction)

``bytes_per_device`` keeps the JAX package's name but holds the eager
bytes (``OpCost.eager_bytes``: every op's inputs and outputs), a figure
that falls with every fusion of the code it measures, and that makes
every cell memory-bound.  Beside it, ``workload_bytes_per_device`` is
set by the step itself (``workload_bytes``: the parameters, optimizer
state, batch and cache the step reads, each once, what it writes of
them, and its new outputs), a fixed target for fusion work; its terms
are ``t_memory_workload`` and ``workload_bottleneck``.

The constants are NVIDIA's data sheet for the H100 SXM 80 GB at its 700 W
limit; a card set below that limit runs slower.  Flops, bytes and
collective bytes come from ``opcost.CostMode`` over the step's aten op
stream (eager, unfused traffic); ``raw_cost_analysis["flops"]`` keeps
``torch.utils.flop_counter.FlopCounterMode``'s total beside it, as the
JAX package keeps XLA's stock ``cost_analysis()``.

MODEL_FLOPS uses 6*N*D (train) or 2*N*D (inference) with N = active
params, D = global tokens; the ratio MODEL_FLOPS / (per-device flops x
chips) flags recomputation and redundancy (remat pushes it below 1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from .opcost import OpCost, storage_key

PEAK_FLOPS = 989e12      # bf16 dense per card
HBM_BW = 3.35e12         # bytes/s per card
LINK_BW = 450e9          # bytes/s per card, NVLink one direction


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: Dict[str, int]
    model_flops: float
    memory_report: dict
    raw_cost_analysis: dict = dataclasses.field(default_factory=dict)
    loop_info: list = dataclasses.field(default_factory=list)
    flops_adjusted_per_device: float = 0.0
    nondot_flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    workload_bytes_per_device: float = 0.0

    @property
    def t_compute(self):
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_compute_adjusted(self):
        f = self.flops_adjusted_per_device or self.flops_per_device
        return f / PEAK_FLOPS

    @property
    def t_memory(self):
        return self.bytes_per_device / HBM_BW

    @property
    def t_memory_workload(self):
        return self.workload_bytes_per_device / HBM_BW

    @property
    def t_collective(self):
        return self.coll_bytes_per_device / LINK_BW

    @property
    def bottleneck(self):
        ts = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(ts, key=ts.get)

    @property
    def workload_bottleneck(self):
        """``bottleneck`` with the workload's bytes in the memory term."""
        ts = {
            "compute": self.t_compute,
            "memory": self.t_memory_workload,
            "collective": self.t_collective,
        }
        return max(ts, key=ts.get)

    @property
    def useful_flops_ratio(self):
        total = self.flops_per_device * self.n_chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self):
        """compute term / the bottleneck term (the floor on step time)."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        return self.t_compute / t if t else 0.0

    def row(self):
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.n_chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "hlo_flops_total": self.flops_per_device * self.n_chips,
            "hlo_flops_raw": self.flops_per_device,
            "hlo_flops_adjusted": self.flops_adjusted_per_device
            or self.flops_per_device,
            "t_compute_adjusted_s": self.t_compute_adjusted,
            "nondot_flops": self.nondot_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "coll_breakdown": self.coll_breakdown,
            "memory": self.memory_report,
            "raw_cost_analysis": self.raw_cost_analysis,
            # the port's additions: the eager bytes the memory term reads,
            # and the workload's own
            "eager_bytes_per_device": self.bytes_per_device,
            "workload_bytes_per_device": self.workload_bytes_per_device,
            "t_memory_workload_s": self.t_memory_workload,
            "workload_bottleneck": self.workload_bottleneck,
        }


def _storage_bytes(tensors) -> Dict[int, int]:
    """storage key -> bytes of the distinct storages under ``tensors``."""
    return {storage_key(t): t.untyped_storage().nbytes() for t in tensors}


def memory_report(cost: OpCost, arguments, outputs) -> dict:
    """XLA's ``memory_analysis()`` keys for a traced call: ``arguments``
    and ``outputs`` are the call's input and output tensors (the tensors
    the step holds: parameters, their held casts, optimizer state,
    batch, cache).  Alias bytes are the argument storages the call wrote
    in place and gave back (the JAX package's donated buffers: params and
    optimizer state of a train step, the cache of a decode step); temp
    bytes are the call's peak allocation less its new outputs, so
    ``resident_bytes`` = arguments + that peak."""
    args = _storage_bytes(arguments)
    outs = _storage_bytes(outputs)
    alias = sum(n for k, n in outs.items() if k in args and k in cost.written)
    new_out = sum(n for k, n in outs.items() if k not in args)
    out = {
        "argument_size_in_bytes": sum(args.values()),
        "output_size_in_bytes": sum(outs.values()),
        "temp_size_in_bytes": max(cost.peak_bytes - new_out, 0),
        "alias_size_in_bytes": alias,
    }
    out["resident_bytes"] = (
        out["argument_size_in_bytes"] + out["output_size_in_bytes"]
        + out["temp_size_in_bytes"] - alias
    )
    return out


def workload_bytes(cost: OpCost, arguments, outputs) -> int:
    """The bytes a step must move whatever its ops: each argument storage
    (parameters, held casts, optimizer state, batch, cache) read once, as
    far as the step's ops read it (a gather: its rows), what the step
    wrote of it in place, at most the storage once, and each new output
    storage once.  Temporaries (activations, gradients) are the code's,
    not the workload's, and are not counted."""
    args = _storage_bytes(arguments)
    outs = _storage_bytes(outputs)
    return (sum(min(n, cost.read.get(k, 0)) for k, n in args.items())
            + sum(min(n, cost.written.get(k, 0)) for k, n in args.items())
            + sum(n for k, n in outs.items() if k not in args))


def model_flops(cfg, cell) -> float:
    n_active = cfg.active_param_count()
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        if cfg.is_encoder_decoder:
            tokens = cell.global_batch * (cell.seq_len + cell.dec_len)
        return 6.0 * n_active * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        if cfg.is_encoder_decoder:
            tokens = cell.global_batch * (cell.seq_len + cell.dec_len)
        return 2.0 * n_active * tokens
    # decode: one token per sequence (+ attention over the cache, which is
    # not in 2ND -- the useful-ratio for decode is expected << 1)
    return 2.0 * n_active * cell.global_batch


def analyze(cost: OpCost, memory: dict, raw_flops: float, arch, shape,
            mesh_name, n_chips, cfg, cell, workload: float = 0.0) -> Roofline:
    """The Roofline of a traced step: ``cost`` from ``CostMode``,
    ``memory`` from ``memory_report``, ``raw_flops`` from
    ``FlopCounterMode``, ``workload`` from ``workload_bytes``."""
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, n_chips=n_chips,
        flops_per_device=cost.flops, bytes_per_device=cost.eager_bytes,
        coll_bytes_per_device=cost.collective_bytes,
        coll_breakdown={k: int(v) for k, v in cost.coll_breakdown.items()},
        model_flops=model_flops(cfg, cell),
        memory_report=memory,
        raw_cost_analysis={"flops": float(raw_flops)},
        loop_info=cost.loop_info[:32],
        flops_adjusted_per_device=cost.flops_adjusted,
        nondot_flops={k: float(v) for k, v in cost.nondot_flops.items()},
        workload_bytes_per_device=float(workload),
    )
