"""Build the CUDA sources under ``csrc/`` with nvcc and load them by ctypes.

Each source is compiled on its own into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), for the
Hopper target ``sm_90a``.  Libraries land in ``build/repro_torch/`` at
the repository root (``REPRO_JIT_CACHE`` moves them: ``perfflags``),
named by a digest of the source and the flags, so an edited source is
rebuilt and an unchanged one is reused.  Builds of
several sources run as parallel nvcc processes.

There is no fallback: a missing nvcc or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from .. import perfflags

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

_COMMON = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# source stem -> extra nvcc flags
SOURCES = {
    "lorenzo": [],
    "cptest": [],
    # the SL stepper must round every f64 op once, as the reference's
    # numpy stepper does: no fused multiply-add contraction
    "semilagrange": ["-fmad=false"],
    "entropy": [],
    "huffman": [],
}

_LOCK = threading.Lock()
_LIBS: dict = {}


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "need the CUDA toolkit to build")
    return path


def _flags(name: str) -> list:
    return _COMMON + SOURCES[name]


def build_dir() -> Path:
    """Where libraries are built and loaded from: ``REPRO_JIT_CACHE``'s
    directory, else ``BUILD_DIR``."""
    return perfflags.apply_jit_cache() or BUILD_DIR


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(_flags(name)).encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:12]}.so"


def build(names=None) -> dict:
    """Compile every named source (default: all) that has no library yet,
    all nvcc processes at once.  Returns {name: seconds} for the builds
    it ran; raises RuntimeError with nvcc's output if one fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = lib_path(n)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [exe, *_flags(n), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    seconds, failed = {}, []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        seconds[n] = time.perf_counter() - t0
        (out_dir / f"{n}.log").write_text(log)
        if p.returncode != 0:
            failed.append(f"nvcc {n}.cu failed ({p.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for one source, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")


def stream_ptr(device) -> ctypes.c_void_p:
    """The calling thread's current stream on ``device``; a launch on it
    runs under ``torch.cuda.device(device)`` (the sources launch on the
    runtime's current device)."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


_COUNT_LOCK = threading.Lock()


def count(wrapper) -> None:
    """One more launch of ``wrapper`` (``wrapper.launches``); wrappers
    launch from the tiles mesh's worker threads too."""
    with _COUNT_LOCK:
        wrapper.launches += 1
