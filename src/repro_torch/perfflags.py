"""Environment switches of the port (the JAX package's ``perfflags``).

Every switch is read when it is used, so tests can monkeypatch the
environment (or, for ``BASELINE``, this module's attribute).

``REPRO_PERF_BASELINE=1`` (``BASELINE``) reverts the perf iterations the
models carry, where the JAX package does:

  H1  the head-sharding ``act(q, "logits")`` on the q / r, k, v
      projections (models/layers.py, rwkv.py; BASELINE skips it, as the
      reference does); it redistributes only over a device mesh
      (sharded execution), and on one card changes nothing
  H2  recomputation of the Mamba and RWKV chunk bodies in the backward
      pass (``checkpoint_if_optimized``)
  H3  Mamba's chunk outputs cast to the activation dtype in the chunk
      body (BASELINE keeps them f32 until the skip connection)
  H5  norm and router statistics from the activation-dtype values (vs
      an f32 copy of the activations and weights)

``REPRO_FUSED=0`` makes ``compress`` run the legacy (seed) binding when
``CompressionConfig.fused`` is None (core/pipeline.py);
``REPRO_BACKEND`` names the SL stepper a compress runs and writes in its
header when ``CompressionConfig.backend`` names none (``numpy``, ``xla``
or ``pallas``, the JAX package's backend names: core/backend.py), and
``numpy`` also allows only the plain versions (CPU); ``REPRO_JIT_CACHE``
moves the directory of the built kernel libraries.
"""
from __future__ import annotations

import os
from pathlib import Path

import torch
from torch.utils.checkpoint import checkpoint

BASELINE = os.environ.get("REPRO_PERF_BASELINE", "") == "1"

# REPRO_BACKEND values: "" -> the hand-written kernels on CUDA, the plain
# versions on the CPU, the default SL stepper; "numpy" -> the JAX
# package's host reference, which in the port is device="cpu": the plain
# versions on the CPU, a CUDA tensor refused, and the numpy SL stepper;
# "xla" and "pallas" -> the JAX package's SL steppers of those names, on
# whatever device the tensors are on
_PLAIN = "numpy"
_BACKENDS = ("numpy", "xla", "pallas")


def backend_override():
    """``REPRO_BACKEND`` (None when unset or empty).  Raises ValueError
    for a name the JAX package has no backend of."""
    name = os.environ.get("REPRO_BACKEND", "") or None
    if name is None or name in _BACKENDS:
        return name
    raise ValueError(f"REPRO_BACKEND={name}: unknown backend; expected "
                     f"unset or one of {_BACKENDS}")


def plain_kernels() -> bool:
    """Whether ``REPRO_BACKEND=numpy`` asks for the plain versions of the
    kernels (the ``ops`` dispatchers read it and refuse CUDA tensors)."""
    return backend_override() == _PLAIN


def fused_default():
    """``REPRO_FUSED=0`` asks for the legacy (seed) binding of
    ``compress``, as ``fused=False`` does.  Default: the fused
    pipeline."""
    return os.environ.get("REPRO_FUSED", "1") != "0"


def jit_cache_dir():
    """``REPRO_JIT_CACHE=<dir>`` puts the built kernel libraries in
    ``<dir>``; ``REPRO_JIT_CACHE=1`` in ``~/.cache/repro_torch/kernels``.
    Unset (or 0): ``build/repro_torch`` at the repository root."""
    v = os.environ.get("REPRO_JIT_CACHE", "").strip()
    if not v or v == "0":
        return None
    if v == "1":
        return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                            "kernels")
    return v


def apply_jit_cache(path=None):
    """The directory the kernel libraries are built into and loaded from:
    ``path``, else ``jit_cache_dir()``, else None (the default build
    directory).  A library is named by a digest of its source and flags,
    so a shared directory never serves a stale build."""
    path = path or jit_cache_dir()
    return Path(path) if path else None


def checkpoint_if_optimized(fn):
    """``fn`` with its activations recomputed in the backward pass
    (``jax.checkpoint``), or ``fn`` itself under BASELINE.  Read when the
    wrapper is made; without grad the wrapper calls ``fn`` directly."""
    if BASELINE:
        return fn

    def remat(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False)

    return remat
