"""Plain PyTorch version of K2: gather the face values, then the int64
SoS predicate of core/sos.py.  Any device."""
from __future__ import annotations

import torch

from ...core import sos


def face_crossed(u_flat: torch.Tensor, v_flat: torch.Tensor,
                 verts: torch.Tensor) -> torch.Tensor:
    return sos.face_crossed_vals(u_flat[verts], v_flat[verts], verts)
