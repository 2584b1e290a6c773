"""Carry the JAX package's parameters across to the port.

``params_from_jax(cfg, tree)`` takes the parameter tree of the JAX
package's ``model.init(...)`` with numpy leaves (``jax.tree.map(
np.asarray, params)``), unstacks the leading layer axis of ``blocks``,
``enc_blocks`` and ``dec_blocks`` and the group axis of Jamba's
``superblocks`` (a list of sub-layer dicts), and returns the port's
state dict.  Names and ``(d_in, d_out)`` layouts are the same in both
packages, so nothing is transposed.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig

_STACKED = ("blocks", "enc_blocks", "dec_blocks")


def _tensor(leaf) -> torch.Tensor:
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}."))
        else:
            out[prefix + key] = val
    return out


def _unstack(flat: dict, prefix: str, n: int, out: dict):
    for name, leaf in flat.items():
        if len(leaf) != n:
            raise ValueError(f"{prefix}{name}: leading axis {len(leaf)}, "
                             f"expected {n}")
        for i in range(n):
            out[f"{prefix}{i}.{name}"] = _tensor(leaf[i])


def params_from_jax(cfg: ModelConfig, tree: dict) -> dict:
    """The JAX parameter tree (numpy leaves) -> the port's state dict."""
    out = {}
    for key, sub in tree.items():
        if key in _STACKED:
            n = cfg.n_enc_layers if key == "enc_blocks" else cfg.n_layers
            _unstack(_flat(sub), f"{key}.", n, out)
        elif key == "superblocks":
            n_groups = cfg.n_layers // cfg.attn_every
            for i, sub_i in enumerate(sub):
                for name, leaf in _flat(sub_i).items():
                    if len(leaf) != n_groups:
                        raise ValueError(f"superblocks[{i}].{name}: leading "
                                         f"axis {len(leaf)}, expected "
                                         f"{n_groups}")
                    for g in range(n_groups):
                        out[f"superblocks.{g}.{i}.{name}"] = _tensor(leaf[g])
        else:
            for name, leaf in _flat(sub).items():
                out[f"{key}.{name}"] = _tensor(leaf)
    return out


def load_params(model, tree: dict):
    """Load the JAX parameter tree into ``model`` (strict: every name of
    both sides must match)."""
    sd = params_from_jax(model.cfg, tree)
    dev = model.device
    model.load_state_dict({k: v.to(dev) for k, v in sd.items()}, strict=True)
    return model
