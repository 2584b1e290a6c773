"""ctypes wrappers of K5 (csrc/entropy.cu): the per-row 256-bin
histogram of a (B, n) uint8 symbol stack, in one persistent launch, and
K6 (csrc/huffman.cu): the Huffman decode of one symbol section.

K5 replaces ``repro/kernels/entropy/kernel.py::symbol_histogram_pallas``;
K6 replaces no TPU kernel (the JAX package decodes on the host).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import TABLE_LEN

# (device index, stream handle) -> int32 workspace of the kernel: per-row
# accumulators and tickets, zero between launches (the kernel leaves them
# so).  Launches on one stream run in order, so one workspace per stream
# is never used by two launches at once.
_WORK: dict = {}


def _fn():
    f = _build.load("entropy").symbol_histogram
    f.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def _workspace(device, stream: int, B: int) -> torch.Tensor:
    key = (device.index, stream)
    work = _WORK.get(key)
    if work is None or work.numel() < B * 257:
        # zeroed once; grows with the largest B seen on this stream
        work = _WORK[key] = torch.zeros(B * 257, dtype=torch.int32,
                                        device=device)
    return work


def symbol_histogram(sym: torch.Tensor) -> torch.Tensor:
    """sym (B, n) uint8, contiguous on a CUDA device.  Returns (B, 256)
    int32 exact counts."""
    if not sym.is_cuda:
        raise ValueError("symbol_histogram kernel needs CUDA tensors")
    if sym.dtype != torch.uint8:
        raise TypeError(f"expected uint8, got {sym.dtype}")
    if not sym.is_contiguous():
        raise ValueError("input must be contiguous")
    if sym.ndim != 2 or sym.shape[0] > 65535 or sym.shape[1] >= 2 ** 31:
        raise ValueError(f"bad shape {tuple(sym.shape)}: expected (B, n) "
                         "with B <= 65535 and n < 2^31")
    B, n = sym.shape
    if B == 0 or n == 0:
        return torch.zeros((B, 256), dtype=torch.int32, device=sym.device)
    hist = torch.empty((B, 256), dtype=torch.int32, device=sym.device)
    with torch.cuda.device(sym.device):
        stream = _build.stream_ptr(sym.device)
        work = _workspace(sym.device, stream.value, B)
        err = _fn()(sym.data_ptr(), B, n, hist.data_ptr(), work.data_ptr(),
                    stream)
    _build.check(err, "symbol_histogram")
    _build.count(symbol_histogram)
    return hist


symbol_histogram.launches = 0


def _decode_fns():
    lib = _build.load("huffman")
    f = lib.huffman_decode
    f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                  ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    f.restype = ctypes.c_int
    w = lib.huffman_workspace
    w.argtypes = [ctypes.c_int64]
    w.restype = ctypes.c_int64
    return f, w


def huffman_decode(stream: torch.Tensor, tab: torch.Tensor, nbits: int,
                   n: int, fill: int):
    """stream: the section's bytes as uint8, zero-padded to a multiple of
    4 bytes and by >= 8 bytes past ``nbits / 8``, 4-byte aligned; tab: the
    int32 decode tables (``ref.TABLE_LEN``), both on one CUDA device.
    Returns (symbols uint8 (n,), status int64 (2,)), as
    ``ref.huffman_decode``.  One launch is one decode: the passes of
    csrc/huffman.cu, queued on the current stream."""
    if not (stream.is_cuda and tab.device == stream.device):
        raise ValueError("huffman_decode kernel needs both tensors on one "
                         "CUDA device")
    if stream.dtype != torch.uint8 or tab.dtype != torch.int32:
        raise TypeError(f"expected uint8 stream and int32 tables, got "
                        f"{stream.dtype}, {tab.dtype}")
    if not (stream.is_contiguous() and tab.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    if tab.numel() != TABLE_LEN:
        raise ValueError(f"tables hold {tab.numel()} entries, expected "
                         f"{TABLE_LEN}")
    if (stream.numel() % 4 or stream.data_ptr() % 4
            or stream.numel() < (nbits + 7) // 8 + 8 or nbits < 0 or n < 0):
        raise ValueError(f"stream of {stream.numel()} bytes cannot hold "
                         f"{nbits} bits with the kernel's padding")
    dev = stream.device
    out = torch.empty(n, dtype=torch.uint8, device=dev)
    status = torch.empty(2, dtype=torch.int64, device=dev)
    f, workspace = _decode_fns()
    work = torch.empty(workspace(nbits), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = f(stream.data_ptr(), tab.data_ptr(), nbits, n, fill,
                out.data_ptr(), status.data_ptr(), work.data_ptr(),
                _build.stream_ptr(dev))
    _build.check(err, "huffman_decode")
    _build.count(huffman_decode)
    return out, status


huffman_decode.launches = 0
