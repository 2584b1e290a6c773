"""Dispatch of the face predicate and the verify round (one field or a
stack of tile units): a CUDA tensor launches K2, a CPU tensor takes the
plain version."""
from __future__ import annotations

import torch

from . import kernel, ref
from .. import use_kernel


def face_crossed(u_flat: torch.Tensor, v_flat: torch.Tensor,
                 verts: torch.Tensor) -> torch.Tensor:
    if use_kernel(u_flat, "face_crossed"):
        return kernel.face_crossed(u_flat, v_flat, verts)
    return ref.face_crossed(u_flat, v_flat, verts)


def verify_faces(ur_fp: torch.Tensor, vr_fp: torch.Tensor, ufp, vfp, delta,
                 slice_tab: torch.Tensor, slab_tab: torch.Tensor,
                 slice0: torch.Tensor, slab0: torch.Tensor,
                 forced: torch.Tensor) -> torch.Tensor:
    args = (ur_fp, vr_fp, ufp, vfp, delta, slice_tab, slab_tab, slice0,
            slab0, forced)
    if use_kernel(ur_fp, "verify_faces"):
        return kernel.verify_faces(*args)
    return ref.verify_faces(*args)


def verify_faces_units(ur_fp: torch.Tensor, vr_fp: torch.Tensor, ufp, vfp,
                       delta, slice_tab: torch.Tensor, slab_tab: torch.Tensor,
                       slice0: torch.Tensor, slab0: torch.Tensor,
                       forced: torch.Tensor) -> torch.Tensor:
    args = (ur_fp, vr_fp, ufp, vfp, delta, slice_tab, slab_tab, slice0,
            slab0, forced)
    if use_kernel(ur_fp, "verify_faces_units"):
        return kernel.verify_faces_units(*args)
    return ref.verify_faces_units(*args)
