"""Dispatch of the face predicate and the verify round (one field or a
stack of tile units): a CUDA tensor launches K2, a CPU tensor takes the
plain version."""
from __future__ import annotations

import torch

from . import kernel, ref


def face_crossed(u_flat: torch.Tensor, v_flat: torch.Tensor,
                 verts: torch.Tensor) -> torch.Tensor:
    if u_flat.is_cuda:
        return kernel.face_crossed(u_flat, v_flat, verts)
    if u_flat.device.type != "cpu":
        raise ValueError(f"no face_crossed for device {u_flat.device}")
    return ref.face_crossed(u_flat, v_flat, verts)


def verify_faces(ur_fp: torch.Tensor, vr_fp: torch.Tensor, ufp, vfp, delta,
                 slice_tab: torch.Tensor, slab_tab: torch.Tensor,
                 slice0: torch.Tensor, slab0: torch.Tensor,
                 forced: torch.Tensor) -> torch.Tensor:
    args = (ur_fp, vr_fp, ufp, vfp, delta, slice_tab, slab_tab, slice0,
            slab0, forced)
    if ur_fp.is_cuda:
        return kernel.verify_faces(*args)
    if ur_fp.device.type != "cpu":
        raise ValueError(f"no verify_faces for device {ur_fp.device}")
    return ref.verify_faces(*args)


def verify_faces_units(ur_fp: torch.Tensor, vr_fp: torch.Tensor, ufp, vfp,
                       delta, slice_tab: torch.Tensor, slab_tab: torch.Tensor,
                       slice0: torch.Tensor, slab0: torch.Tensor,
                       forced: torch.Tensor) -> torch.Tensor:
    args = (ur_fp, vr_fp, ufp, vfp, delta, slice_tab, slab_tab, slice0,
            slab0, forced)
    if ur_fp.is_cuda:
        return kernel.verify_faces_units(*args)
    if ur_fp.device.type != "cpu":
        raise ValueError(f"no verify_faces_units for device {ur_fp.device}")
    return ref.verify_faces_units(*args)
