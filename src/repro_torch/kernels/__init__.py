"""Hand-written Hopper kernels of the port and their plain versions.

Each kernel package holds ``kernel.py`` (the ctypes wrapper that
launches the CUDA kernel and counts its launches), ``ref.py`` (the
plain PyTorch version of the same function) and ``ops.py`` (dispatch on
the tensor's device: CUDA -> kernel, CPU -> plain version;
``REPRO_BACKEND=numpy`` refuses CUDA tensors).
"""
from . import _build
from .. import perfflags

KERNELS = ("lorenzo", "cptest", "semilagrange", "entropy", "huffman")


def build_all() -> dict:
    """Build every kernel library (parallel nvcc); {name: seconds}."""
    return _build.build(KERNELS)


def use_kernel(t, what: str) -> bool:
    """Whether ``what`` on ``t`` launches its kernel: a CUDA tensor does,
    a CPU tensor takes the plain version, any other device raises.
    ``REPRO_BACKEND=numpy`` (the reference's host backend) raises for a
    CUDA tensor: the plain versions run on the CPU only."""
    plain = perfflags.plain_kernels()
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no {what} for device {t.device}")
    if t.is_cuda and plain:
        raise ValueError(
            f"REPRO_BACKEND=numpy asks for the plain version of {what}, "
            f"which runs on the CPU only; pass device=\"cpu\" for the plain "
            f"versions, or unset REPRO_BACKEND for the kernels on CUDA")
    return t.is_cuda
