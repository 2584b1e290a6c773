"""Atomic checkpoints in the JAX package's on-disk format (the port of
``repro.train.checkpoint``).

Layout (one directory per step):

    <dir>/step_000123/
        manifest.json       step, time, leaf index, data hash, meta
        arrays.npz          "<tree>:<path/with/slashes>" -> host array
    <dir>/LATEST            atomic pointer (tmp + rename)

``trees`` are nested dicts / lists of torch tensors or numpy arrays,
flattened as JAX flattens a pytree (dict keys sorted, list items by
index).  Give them in the reference's layout (``convert.params_to_jax``
of a state dict; the launcher does) and a checkpoint written by either
package restores in the other.  ``lossy_rel_eb`` stores large float
leaves as the paper's eb-quantized int32 codes.  Writes go to a tmp dir
+ atomic rename; a crashed write never corrupts LATEST.

A leaf numpy cannot hold (bf16) raises the reference's ``TypeError``
("non-numeric checkpoint leaf ..."): the reference cannot save bf16
leaves either, and the port keeps its format.

Sharded leaves (DTensors on a device mesh) are gathered before ``save``
(``launch.train.save_checkpoint``: every rank gathers, rank 0 writes
the same bytes as a one-device save of the same values, the others wait
at a barrier); ``save`` refuses a DTensor leaf.  ``restore(...,
shardings=)`` places each leaf on a mesh, any mesh: a checkpoint saved
on one layout restores onto another (the elastic / mesh-reshape path).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


class CheckpointError(RuntimeError):
    """A checkpoint is absent, incomplete, or inconsistent with the
    restore template.  A real error class (not ``assert``): restore
    validation must survive ``python -O``, and callers recovering from
    a crashed trainer need a typed failure to catch."""


def _leaves(tree, path=()):
    """(path, leaf) pairs in JAX's pytree order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _leaves(t, path + (i,))
    elif tree is not None:
        yield path, tree


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _host(key: str, leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if hasattr(leaf, "full_tensor"):          # a DTensor
            raise TypeError(f"sharded checkpoint leaf {key}: gather it "
                            "first (launch.train.save_checkpoint)")
        if leaf.dtype == torch.bfloat16:
            raise TypeError(f"non-numeric checkpoint leaf {key}: bfloat16")
        leaf = leaf.cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype == object or arr.dtype.kind not in "biufc":
        raise TypeError(f"non-numeric checkpoint leaf {key}: {arr.dtype}")
    return arr


def _flatten(tree) -> dict:
    return {_key(path): _host(_key(path), leaf)
            for path, leaf in _leaves(tree)}


def _lossy_encode(arr: np.ndarray, rel_eb: float):
    """Paper-style eb quantization of a float leaf: uniform quantum
    2*eb_abs and int32 codes.  Returns (codes, scale) or None when the
    leaf is not worth quantizing."""
    if arr.dtype.kind != "f" or arr.size < 1024:
        return None
    rng = float(np.abs(arr).max())
    if rng == 0.0:
        return None
    q = 2.0 * rel_eb * rng
    codes = np.round(arr.astype(np.float64) / q).astype(np.int32)
    return codes, np.float64(q)


def save(directory: str, step: int, trees: Dict[str, Any],
         meta: Optional[dict] = None, keep: int = 3,
         lossy_rel_eb: Optional[float] = None) -> str:
    """Atomically persist ``trees`` (e.g. {'params': ..., 'opt': ...});
    keeps the newest ``keep`` steps."""
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:08d}"
    final = os.path.join(directory, name)
    tmp = tempfile.mkdtemp(prefix=f".{name}.tmp", dir=directory)
    try:
        arrays = {}
        index = {}
        for tree_name, tree in trees.items():
            for k, v in _flatten(tree).items():
                key = f"{tree_name}:{k}"
                entry = {"shape": list(v.shape), "dtype": str(v.dtype)}
                enc = _lossy_encode(v, lossy_rel_eb) if lossy_rel_eb \
                    else None
                if enc is not None:
                    arrays[key], q = enc
                    entry["lossy_q"] = float(q)
                else:
                    arrays[key] = v
                index[key] = entry
        np.savez_compressed(os.path.join(tmp, "arrays.npz"), **arrays)
        digest = hashlib.sha256()
        for k in sorted(arrays):
            digest.update(k.encode())
            digest.update(arrays[k].tobytes()[:4096])
        manifest = {
            "step": step,
            "time": time.time(),
            "leaves": index,
            "hash": digest.hexdigest(),
            "meta": meta or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    ptr_tmp = os.path.join(directory, ".LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(name)
    os.replace(ptr_tmp, os.path.join(directory, "LATEST"))
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int):
    steps = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_") and os.path.isdir(os.path.join(directory, d))
    )
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    ptr = os.path.join(directory, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(directory, name)):
        return None
    return int(name.split("_")[1])


def _rebuild(template, path, fetch):
    if isinstance(template, dict):
        return {k: _rebuild(template[k], path + (k,), fetch)
                for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(t, path + (i,), fetch)
                              for i, t in enumerate(template))
    if template is None:
        return None
    return fetch(path, template)


def restore(directory: str, template_trees: Dict[str, Any],
            shardings: Optional[Dict[str, Any]] = None,
            step: Optional[int] = None):
    """Restore into the structure of ``template_trees`` (leaves with a
    ``shape``: tensors or arrays).  Returns (trees, manifest): host numpy
    arrays, or, where ``shardings`` (trees of ``NamedSharding`` over
    ``torch.distributed`` device meshes, matching the templates) gives a
    leaf one, a DTensor with that spec holding this rank's slice."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise CheckpointError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        out = {}
        for tree_name, template in template_trees.items():

            def fetch(lpath, leaf, tree_name=tree_name):
                key = tree_name + ":" + _key(lpath)
                if key not in data.files:
                    raise CheckpointError(f"checkpoint has no leaf {key}")
                arr = data[key]
                meta_leaf = manifest["leaves"].get(key, {})
                if "lossy_q" in meta_leaf:
                    arr = (arr.astype(np.float64) * meta_leaf["lossy_q"]
                           ).astype(np.dtype(meta_leaf["dtype"]))
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise CheckpointError(
                        f"checkpoint leaf {key} has shape "
                        f"{tuple(arr.shape)}, template expects "
                        f"{tuple(leaf.shape)}")
                return arr

            out[tree_name] = _rebuild(template, (), fetch)
    if shardings:
        for tree_name, shd_tree in shardings.items():
            out[tree_name] = _place(out[tree_name], shd_tree)
    return out, manifest


def _place(tree, shardings):
    """``tree``'s arrays placed by the matching ``shardings`` tree."""
    if shardings is None:
        return tree
    if isinstance(tree, dict):
        return {k: _place(v, shardings.get(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place(t, s) for t, s in zip(tree, shardings))
    from ..parallel.sharding import place

    return place(torch.from_numpy(np.ascontiguousarray(tree)),
                 shardings.spec, shardings.mesh)
