"""Critical-point-trajectory-preserving compressor (paper Alg. 3).

Public API:

    blob, stats = compress(u, v, CompressionConfig(eb=...))
    u_rec, v_rec = decompress(blob)

Both run on the CUDA device unless the caller passes ``device="cpu"``;
with no CUDA device and ``device=None`` they raise RuntimeError.  The
container is the JAX package's monolithic format (version 2), byte-equal
to what the JAX package writes with the same backend for the same field
and config.  ``backend`` takes the JAX package's names, which here name
the SL stepper and the header's ``sl_backend`` tag (core/backend.py):
None (or ``REPRO_BACKEND`` unset) writes "numpy", "xla" and "pallas"
run the JAX package's steppers of those names on whatever device the
tensors are on, and "numpy" given by name also keeps to the plain
versions on the CPU (as ``REPRO_BACKEND=numpy``).  ``decompress`` replays
the stepper its container names, so it reads what the JAX package writes
with any backend off the TPU (a "pallas" container written on a TPU
holds that TPU's arithmetic, which no other machine reproduces).

``codec="device"`` entropy-codes the residuals on the device and writes
the JAX package's CPTH1 container, byte-equal to its ``codec="device"``
container with the numpy SL stepper; ``decompress`` reads both kinds.

``eb_policy`` takes an adaptive per-(window, tile) policy
(``ebpolicy.TilePolicy`` or its spec): the plan derives from the
policy's loosest bound, each vertex's bound is clamped down to its own,
and the container is the reference's version 3 with the policy in its
header.  Pair a policy with ``n_levels=ebpolicy.levels_for(policy)``.

``tiling=TileGrid(...)`` compresses tile by tile into the reference's
random-access CPTT1 container (core/tiling.py: version 4, 5 with the
device codec, 6 with an adaptive policy, the track index in its footer
unless ``track_index=False``); ``decompress`` reads it too.

``autotune=True`` runs the plan the cost model picks for the field
(repro_torch.autotune: the same bytes as that plan set by hand); the plan
includes the SL stepper (the backend arm: "pallas", "xla" or "numpy" on
CUDA, "xla" or "numpy" on the CPU), which replaces the caller's
``backend`` and is the container's ``sl_backend``;
``target_ratio=`` searches a two-valued adaptive policy that reaches the
ratio with the trajectory-covering units kept at ``eb``
(autotune/rate.py).

``CompressionConfig`` keeps the JAX package's fields and defaults.
``fused=False`` (or ``REPRO_FUSED=0`` with ``fused=None``) runs the
legacy (seed) binding (core/pipeline.py: unfused quantize and predict,
every face re-checked each verify round, the "xla" SL stepper whatever
``backend`` says) and writes the JAX package's ``"pipeline": "legacy"``
container; the tiled and streamed entries ignore ``fused``, as the JAX
package's do.  ``decompress(blob, backend)`` decodes with the SL
stepper ``backend`` names in place of the header's (a legacy container
always with "xla").  The device picks kernel or plain version;
``backend="numpy"`` and ``REPRO_BACKEND=numpy`` refuse CUDA tensors and
leave the plain versions on the CPU (``perfflags``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from . import (backend, ebpolicy, encode, fixedpoint, pipeline, predictors,
               quantize)
from .. import obs, perfflags

FORMAT_VERSION = pipeline.FORMAT_VERSION


@dataclasses.dataclass
class CompressionConfig:
    eb: float = 1e-2                  # error bound
    mode: str = "rel"                 # 'abs' or 'rel' (relative to value range)
    predictor: str = "mop"            # 'mop' | 'lorenzo' | 'sl'
    block: int = predictors.DEFAULT_BLOCK
    n_levels: int = quantize.DEFAULT_LEVELS
    fixed_bits: int = fixedpoint.DEFAULT_BITS
    dt: float = 1.0
    dx: float = 1.0
    dy: float = 1.0
    d_max: float = 2.0
    n_max: int = 32
    zstd_level: int = 12
    verify: bool = True
    max_rounds: int = 12
    backend: Optional[str] = None     # SL stepper: None | numpy | xla | pallas
    fused: Optional[bool] = None      # None / True: the fused pipeline
    tiling: Optional[object] = None   # a tiling.TileGrid: tiled container
    track_index: bool = True          # tiled only
    batch_units: bool = True          # tiled only
    codec: str = "host"               # 'host' (CPTZ1/CPTL1) | 'device' (CPTH1)
    batch_cap: int = 8                # tiled only
    q_in_frames: Optional[int] = None   # streaming only
    q_out_units: Optional[int] = None   # streaming only
    eb_policy: Optional[object] = None  # None / "uniform" or a TilePolicy


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA device (RuntimeError without one)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def refuse_unported(cfg: CompressionConfig):
    """Raise for config values this package does not know."""
    # an unknown backend name (in the config or REPRO_BACKEND) raises
    backend.resolve(cfg.backend)
    if cfg.codec not in ("host", "device"):
        raise ValueError(f"unknown codec {cfg.codec!r}; expected 'host' "
                         "or 'device'")


def refuse_plain_on_card(cfg, dev: torch.device):
    """``backend="numpy"`` asks for the plain versions, which run on the
    CPU only (as ``REPRO_BACKEND=numpy`` does): raise for a CUDA device.
    ``cfg``: a CompressionConfig, or a decode entry's ``backend=``."""
    name = cfg if cfg is None or isinstance(cfg, str) else cfg.backend
    if name == "numpy" and dev.type == "cuda":
        raise ValueError(
            'backend="numpy" asks for the plain versions of the kernels, '
            'which run on the CPU only; pass device="cpu", or leave '
            "backend=None for the kernels on CUDA (the same bytes)")


def _as_fields(u, v):
    u = np.asarray(u)
    v = np.asarray(v)
    if u.shape != v.shape or u.ndim != 3:
        raise ValueError(
            f"expect (T, H, W) u and v, got {u.shape} and {v.shape}")
    if min(u.shape) < 2:
        raise ValueError(
            f"need at least a 2x2x2 space-time grid, got {u.shape}")
    return u.astype(np.float32), v.astype(np.float32)


def _eb_factor(u, v, cfg) -> float:
    """1.0 for ``abs``, the value range for ``rel``."""
    if cfg.mode == "abs":
        return 1.0
    lo = min(u.min(), v.min())
    hi = max(u.max(), v.max())
    # the subtraction stays in the fields' float32, as in the JAX package
    rng = float(hi - lo)
    ebpolicy.check_relative_range(rng, max(abs(float(lo)), abs(float(hi))))
    return max(rng, 1e-30)


def compress(u, v, cfg: Optional[CompressionConfig] = None, *,
             device=None, autotune: bool = False,
             target_ratio: Optional[float] = None):
    """Compress a (T, H, W) pair of float fields.  Returns (blob, stats)."""
    if cfg is None:
        cfg = CompressionConfig()
    refuse_unported(cfg)
    if target_ratio is not None:
        from ..autotune import rate
        return rate.compress_with_target(u, v, cfg, float(target_ratio),
                                         device=device)
    if autotune:
        from .. import autotune as autotune_mod
        cfg = autotune_mod.tune_config(u, v, cfg, device=device)
    if cfg.tiling is not None:
        from . import tiling
        return tiling.compress_tiled(u, v, cfg, cfg.tiling, device=device)
    dev = resolve_device(device)
    refuse_plain_on_card(cfg, dev)
    t0 = time.perf_counter()
    with obs.span("compressor.prepare") as sp:
        u, v = _as_fields(u, v)
        sp.set(shape=list(u.shape))
        pol = ebpolicy.normalize(cfg.eb_policy)
        factor = _eb_factor(u, v, cfg)
        # the plan's global (tau, xi_unit) derive from the policy's
        # LOOSEST bound; the per-vertex caps only clamp down from there
        eb_abs = float(cfg.eb if pol is None
                       else ebpolicy.max_bound(pol)) * factor
        scale, ufp, vfp = fixedpoint.to_fixed(u, v, cfg.fixed_bits)
        fused = perfflags.fused_default() if cfg.fused is None else cfg.fused
        ex = pipeline.PlanExecutor(pipeline.plan_from_cfg(
            cfg, scale, eb_abs, "fused" if fused else "legacy"), dev)
    if pol is None:
        enc = pipeline.compress_field(ex, u, v, ufp, vfp)
    else:
        enc = pipeline.compress_field(
            ex, u, v, ufp, vfp,
            eb_cap=ebpolicy.field_caps(pol, u.shape, factor, scale),
            eb_bound=ebpolicy.field_bounds(pol, u.shape, factor))
    return pipeline.pack_field(ex, u, v, enc, t0)


def decompress(blob: bytes, backend: Optional[str] = None, *, device=None):
    """Container bytes -> (u, v) float32 numpy arrays (T, H, W).
    ``backend`` names the SL stepper of the decode in place of the
    header's ("numpy", "xla" or "pallas"; a legacy container ignores
    it)."""
    if encode.is_tiled(blob):
        from . import tiling
        return tiling.decompress_tiled(blob, backend=backend, device=device)
    dev = resolve_device(device)
    refuse_plain_on_card(backend, dev)
    header, sections = encode.unpack(blob, dev)
    version = header.get("version", 1)
    if not isinstance(version, int) \
            or version > pipeline.FORMAT_VERSION_ADAPTIVE:
        raise ValueError(
            f"container format version {version} is newer than this "
            f"decoder (supports <= {pipeline.FORMAT_VERSION_ADAPTIVE})")
    ex = pipeline.executor_from_header(header, dev, backend)
    return pipeline.decode_field_blob(ex, header, sections)
