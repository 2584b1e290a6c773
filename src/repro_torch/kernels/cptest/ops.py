"""Dispatch of the face predicate: a CUDA tensor launches K2, a CPU
tensor takes the plain version."""
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
