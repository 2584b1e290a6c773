"""Carry the JAX package's parameters across to the port.

``params_from_jax(cfg, tree)`` takes the parameter tree of the JAX
package's ``model.init(...)`` with numpy leaves (``jax.tree.map(
np.asarray, params)``), unstacks the leading layer axis of ``blocks``,
``enc_blocks`` and ``dec_blocks`` and the group axis of Jamba's
``superblocks`` (a list of sub-layer dicts), and returns the port's
state dict.  Names and ``(d_in, d_out)`` layouts are the same in both
packages, so nothing is transposed.  ``params_to_jax(cfg, state_dict)``
is its inverse: it stacks those axes again into the reference's nested
tree (torch leaves), the layout of the reference's optimizer states and
checkpoints too.
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


def _nest(flat: dict) -> dict:
    out = {}
    for name, leaf in flat.items():
        *path, last = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out


def _leaf_of(name: str):
    """(the reference leaf a port parameter slices: (container, sub-layer
    or None, path within it), its index on the stacked axis or None)."""
    key, rest = name.split(".", 1)
    if key in _STACKED:
        i, leaf = rest.split(".", 1)
        return (key, None, leaf), int(i)
    if key == "superblocks":
        g, i, leaf = rest.split(".", 2)
        return (key, int(i), leaf), int(g)
    return (key, None, rest), None


def is_stacked(name: str) -> bool:
    """Whether the port parameter ``name`` is one layer's (or one group's)
    slice of a leaf that the reference stacks over its layers (groups)."""
    return _leaf_of(name)[1] is not None


def stacked_groups(names) -> list:
    """The port parameter names grouped by the reference leaf they are
    slices of, each group in stacked-axis order (an unstacked name is a
    group of its own)."""
    groups = {}
    for name in names:
        leaf, idx = _leaf_of(name)
        groups.setdefault(leaf, []).append((-1 if idx is None else idx, name))
    return [[n for _, n in sorted(g)] for g in groups.values()]


def params_to_jax(cfg: ModelConfig, state_dict: dict) -> dict:
    """The port's state dict (or any dict keyed by its parameter names,
    e.g. Adam moments) -> the reference's nested tree, leaves stacked
    over the layer axis of ``blocks`` / ``enc_blocks`` / ``dec_blocks``
    and the group axis of ``superblocks`` (a list of sub-layer dicts).
    Leaves stay torch tensors on their device."""
    n_stacked = {"blocks": cfg.n_layers, "dec_blocks": cfg.n_layers,
                 "enc_blocks": cfg.n_enc_layers,
                 "superblocks": cfg.n_layers // max(cfg.attn_every, 1)}
    flat = {}                      # (container, sub-layer) -> {path: leaf}
    for group in stacked_groups(state_dict):
        (key, sub, path), idx = _leaf_of(group[0])
        if idx is None:
            val = state_dict[group[0]]
        else:
            got = [_leaf_of(n)[1] for n in group]
            if got != list(range(n_stacked[key])):
                raise ValueError(f"{key}.{path}: layers {got}, expected "
                                 f"0..{n_stacked[key] - 1}")
            val = torch.stack([state_dict[n] for n in group])
        flat.setdefault((key, sub), {})[path] = val
    tree = {key: _nest(leaves) for (key, sub), leaves in flat.items()
            if sub is None}
    subs = {sub: _nest(leaves) for (key, sub), leaves in flat.items()
            if sub is not None}
    if subs:
        tree["superblocks"] = [subs[i] for i in range(len(subs))]
    return tree
