"""Hand-written Hopper kernels of the port and their plain versions.

Each kernel package holds ``kernel.py`` (the ctypes wrapper that
launches the CUDA kernel and counts its launches), ``ref.py`` (the
plain PyTorch version of the same function) and ``ops.py`` (dispatch on
the tensor's device: CUDA -> kernel, CPU -> plain version).
"""
from . import _build

KERNELS = ("lorenzo", "cptest", "semilagrange", "entropy")


def build_all() -> dict:
    """Build every kernel library (parallel nvcc); {name: seconds}."""
    return _build.build(KERNELS)
