"""ctypes wrappers of K2 (csrc/cptest.cu): the exact SoS face-crossing
predicate with the vertex-value gather fused in (``face_crossed``), and
one verify round of the encoder's fixpoint built on it, in one launch,
for one field (``verify_faces``) or a stack of same-shape tile units
(``verify_faces_units``).

Replaces ``repro/kernels/cptest/kernel.py::face_crossed_pallas``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ...core import grid

# (device index, stream handle) -> verify_faces' workspace of two uint64
# (the bad-face sum and the CTA ticket), zero between launches (the kernel
# leaves them so).  Launches on one stream run in order, so one workspace
# per stream is never used by two launches at once.
_WORK: dict = {}


def _fn():
    f = _build.load("cptest").face_crossed
    f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def _verify_fn():
    f = _build.load("cptest").verify_faces
    p, i32 = ctypes.c_void_p, ctypes.c_int
    f.argtypes = [p, p, p, p, p, p, p, i32, i32, p, p, i32, i32, i32, p, p,
                  p, p]
    f.restype = ctypes.c_int
    return f


def _units_fn():
    f = _build.load("cptest").verify_faces_units
    p, i32 = ctypes.c_void_p, ctypes.c_int
    f.argtypes = [p, p, p, p, p, p, p, i32, i32, p, p, i32, i32, i32, i32, p,
                  p, p, p]
    f.restype = ctypes.c_int
    return f


def _check(tensors, dtype, what):
    first = tensors[0]
    if not first.is_cuda:
        raise ValueError(f"{what} kernel needs CUDA tensors")
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"expected {dtype}, got {t.dtype}")
        if t.device != first.device:
            raise ValueError("inputs on different devices")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")


def face_crossed(u_flat: torch.Tensor, v_flat: torch.Tensor,
                 verts: torch.Tensor) -> torch.Tensor:
    """u_flat, v_flat (N_v,) int64 vertex values (|.| <= 2^30); verts
    (N, 3) int64 global vertex ids in [0, N_v), all contiguous on one
    CUDA device.  Returns (N,) bool."""
    _check((u_flat, v_flat, verts), torch.int64, "face_crossed")
    if u_flat.ndim != 1 or v_flat.shape != u_flat.shape \
            or verts.ndim != 2 or verts.shape[1] != 3:
        raise ValueError(f"bad shapes {tuple(u_flat.shape)} "
                         f"{tuple(v_flat.shape)} {tuple(verts.shape)}")
    n = verts.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=u_flat.device)
    with torch.cuda.device(u_flat.device):
        err = _fn()(u_flat.data_ptr(), v_flat.data_ptr(), verts.data_ptr(),
                    out.data_ptr(), n, _build.stream_ptr(u_flat.device))
    _build.check(err, "face_crossed")
    _build.count(face_crossed)
    return out


face_crossed.launches = 0


def verify_faces(ur_fp: torch.Tensor, vr_fp: torch.Tensor, ufp, vfp,
                 delta, slice_tab: torch.Tensor, slab_tab: torch.Tensor,
                 slice0: torch.Tensor, slab0: torch.Tensor,
                 forced: torch.Tensor) -> torch.Tensor:
    """One verify round over every slice and slab face, in one launch.

    ur_fp, vr_fp (T, H, W) int64 reconstructions (|.| <= 2^30); ufp, vfp
    the originals, read only when ``delta`` is None (the screen); delta
    (T, H, W) bool or None; slice_tab (Fs, 3) / slab_tab (Fb, 3) int64
    local ids of ``grid.device_tables``; slice0 (T, Fs) / slab0 (T-1, Fb)
    bool original predicates; forced (T, H, W) bool, updated in place.
    All contiguous on one CUDA device.  The kernel walks the faces of
    ``grid.face_walk(H, W)``, the same faces as the tables (checked by
    their lengths).  Any W: the kernel splits wide planes into blocks of
    columns.  Returns the number of bad faces as a 0-d int64 tensor on
    the device."""
    out = _launch_verify(None, ur_fp, vr_fp, ufp, vfp, delta, slice_tab,
                         slab_tab, slice0, slab0, forced)
    _build.count(verify_faces)
    return out


verify_faces.launches = 0


def verify_faces_units(ur_fp: torch.Tensor, vr_fp: torch.Tensor, ufp, vfp,
                       delta, slice_tab: torch.Tensor,
                       slab_tab: torch.Tensor, slice0: torch.Tensor,
                       slab0: torch.Tensor,
                       forced: torch.Tensor) -> torch.Tensor:
    """``verify_faces`` of B same-shape tile units in one launch: the
    fields, delta and forced (B, T, H, W), slice0 (B, T, Fs), slab0 (B,
    T-1, Fb); the tables are the units' shared ones.  Returns the bad
    faces of all units as one 0-d int64 tensor."""
    if ur_fp.ndim != 4 or ur_fp.shape[0] < 1:
        raise ValueError(f"bad unit stack shape {tuple(ur_fp.shape)}")
    out = _launch_verify(ur_fp.shape[0], ur_fp, vr_fp, ufp, vfp, delta,
                         slice_tab, slab_tab, slice0, slab0, forced)
    _build.count(verify_faces_units)
    return out


verify_faces_units.launches = 0


def _launch_verify(B, ur_fp, vr_fp, ufp, vfp, delta, slice_tab, slab_tab,
                   slice0, slab0, forced):
    """Checks and launch of both entries; B None is the whole-field one."""
    screen = delta is None
    fields = [ur_fp, vr_fp] + ([ufp, vfp] if screen else [])
    _check(fields + [slice_tab, slab_tab], torch.int64, "verify_faces")
    _check([forced, slice0, slab0] + ([] if screen else [delta]),
           torch.bool, "verify_faces")
    if forced.device != ur_fp.device:
        raise ValueError("inputs on different devices")
    lead = () if B is None else (B,)
    if ur_fp.ndim != 3 + len(lead) or ur_fp.shape[len(lead)] < 1:
        raise ValueError(f"bad field shape {tuple(ur_fp.shape)}")
    T, H, W = ur_fp.shape[len(lead):]
    Fs, Fb = slice_tab.shape[0], slab_tab.shape[0]
    for t in fields + [forced] + ([] if screen else [delta]):
        if t.shape != ur_fp.shape:
            raise ValueError(f"field shapes differ: {tuple(t.shape)} vs "
                             f"{tuple(ur_fp.shape)}")
    if slice_tab.shape != (Fs, 3) or slab_tab.shape != (Fb, 3) \
            or slice0.shape != lead + (T, Fs) \
            or slab0.shape != lead + (T - 1, Fb):
        raise ValueError(
            f"bad face shapes {tuple(slice_tab.shape)} "
            f"{tuple(slab_tab.shape)} {tuple(slice0.shape)} "
            f"{tuple(slab0.shape)} for T = {T}")
    if Fs + Fb >= 2 ** 31 or 2 * H * W >= 2 ** 31:
        raise ValueError(f"{Fs + Fb} faces on {H}x{W} planes: the face "
                         "records are int32")
    dev = ur_fp.device
    out = torch.empty((), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = _build.stream_ptr(dev)
        key = (dev.index, stream.value)
        work = _WORK.get(key)
        if work is None:
            work = _WORK[key] = torch.zeros(2, dtype=torch.int64, device=dev)
        records, start = grid.face_walk(H, W, str(dev))
        if records.shape[0] != Fs + Fb:
            raise ValueError(f"{Fs} + {Fb} faces are not the mesh's "
                             f"{records.shape[0]} on {H}x{W} planes")
        args = [ur_fp.data_ptr(), vr_fp.data_ptr(),
                ufp.data_ptr() if screen else None,
                vfp.data_ptr() if screen else None,
                None if screen else delta.data_ptr(),
                records.data_ptr(), start.data_ptr(), Fs, Fb,
                slice0.data_ptr(), slab0.data_ptr()]
        args += ([T, H, W] if B is None else [B, T, H, W])
        args += [forced.data_ptr(), work.data_ptr(), out.data_ptr(), stream]
        err = (_verify_fn() if B is None else _units_fn())(*args)
    _build.check(err, "verify_faces")
    return out
