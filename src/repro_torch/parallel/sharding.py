"""Apply a per-unit function over a leading unit axis, and the shared
host thread pools of the read path.

The JAX package shard_maps same-signature tile units over a device mesh
(``map_tiles``) and pads ragged batches to the device count
(``map_tiles_padded``).  The port runs one card, and its unit-batched
stages are kernels with a unit axis of their own (core/backend.py), so
here the two are the same thing: ``fn`` applied to every row of the
stacked inputs, the results stacked again.  It is what the plain
versions of the unit-batched kernels are built from.  Spreading units
over several cards is not ported.
"""
from __future__ import annotations

import functools

import torch

DEFAULT_HOST_WORKERS = 8


def _stack(outs):
    first = outs[0]
    if isinstance(first, tuple):
        return tuple(_stack([o[k] for o in outs]) for k in range(len(first)))
    return torch.stack(outs)


def map_tiles(fn, *batched):
    """``fn`` (one unit's tensors -> a tensor or a tuple of tensors)
    over the leading unit axis of ``batched``; outputs stacked on it."""
    n = int(batched[0].shape[0])
    if n == 0:
        raise ValueError("map_tiles needs at least one unit")
    return _stack([fn(*(b[i] for b in batched)) for i in range(n)])


# one card: nothing to pad to a device-count multiple
map_tiles_padded = map_tiles


@functools.lru_cache(maxsize=8)
def host_pool(name: str, workers: int = DEFAULT_HOST_WORKERS):
    """Named, process-lifetime ThreadPoolExecutor for host-side I/O."""
    from concurrent.futures import ThreadPoolExecutor

    return ThreadPoolExecutor(max_workers=workers,
                              thread_name_prefix=f"repro-torch-{name}")


def host_map(pool, fn, items):
    """``pool.map`` that awaits every item and re-raises the first
    worker exception (in item order) on the caller's thread.  Returns
    the results in item order."""
    futures = [pool.submit(fn, it) for it in items]
    results, first_exc = [], None
    for f in futures:
        try:
            results.append(f.result())
        except BaseException as e:     # noqa: BLE001 -- re-raised below
            if first_exc is None:
                first_exc = e
            results.append(None)
    if first_exc is not None:
        raise first_exc
    return results
