"""The compressor's tiles mesh (``repro_torch.parallel.sharding``:
``tiles_devices``, ``deal``, ``map_cards``) on the CPU.

The tiled compressor deals its unit chunks, eb-derivation groups and
track-index groups to the cards of the mesh; the container bytes must
not depend on how many there are.  Here the mesh is the CPU listed k
times (``sharding.tiles_devices`` replaced, as chip_smoke does with one
card listed twice), which runs k worker threads.  Streams (serial and
async engine) equal the one-device ``compress_tiled`` bytes; the byte
comparisons of ``compress_tiled`` over k workers against the JAX
package are in tests/test_torch_tiling.py and
tests/test_torch_tiled_container.py, beside the reference blobs of
their fields.  The last test pins a fault of the reference's own
multi-device path (ROADMAP Queue 3 item 14).
"""
import pytest

pytest.importorskip("torch")

import os
import subprocess
import sys
import textwrap
import threading

import torch

import repro_torch
from repro_torch import obs
from repro_torch.data import synthetic
from repro_torch.parallel import sharding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the fixtures of tests/test_torch_tiling.py
GRID = (6, 8, 3)
CPU = torch.device("cpu")


def cpu_mesh(monkeypatch, k):
    monkeypatch.setattr(sharding, "tiles_devices", lambda device: [CPU] * k)


@pytest.fixture(scope="module")
def field():
    return synthetic.double_gyre(T=6, H=20, W=28)


@pytest.fixture(scope="module")
def one_card(field):
    """The one-device tiled containers of the host and device codecs."""
    u, v = field
    return {codec: repro_torch.compress_tiled(
        u, v, repro_torch.CompressionConfig(eb=1e-2, codec=codec),
        repro_torch.TileGrid(*GRID), device="cpu") for codec in
        ("host", "device")}


def _vrange(u, v):
    return (float(min(u.min(), v.min())), float(max(u.max(), v.max())))


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("async_engine", [False, True])
def test_stream_bytes_equal_one_device(monkeypatch, field, one_card, k,
                                       async_engine):
    u, v = field
    cpu_mesh(monkeypatch, k)
    blob, st = repro_torch.compress_stream(
        ((u[t], v[t]) for t in range(u.shape[0])),
        repro_torch.CompressionConfig(eb=1e-2), repro_torch.TileGrid(*GRID),
        value_range=_vrange(u, v), async_engine=async_engine, device="cpu")
    want, st1 = one_card["host"]
    assert blob == want
    units = st["chunks"]["units"]
    assert sum(units["emit"]) == st["n_units"] == 32
    assert len(units["emit"]) == k and min(units["emit"]) > 0
    assert st["chunks"]["emit"] == st1["chunks"]["emit"]


@pytest.mark.parametrize("codec", ["host", "device"])
def test_spans_and_counters_match_one_device(monkeypatch, field, one_card,
                                             codec):
    """Every worker thread keeps its own span stack: the same span names,
    the same units written and verify rounds as on one device."""
    u, v = field

    def traced():
        snap0 = obs.snapshot()
        blob, _ = repro_torch.compress_tiled(
            u, v, repro_torch.CompressionConfig(eb=1e-2, codec=codec),
            repro_torch.TileGrid(*GRID), device="cpu")
        snap1 = obs.snapshot()
        spans = {n for n in snap1 if n.startswith("span.") and
                 snap1[n]["count"] != snap0.get(n, {}).get("count", 0)}
        counts = {n: snap1[n]["value"] - snap0.get(n, {}).get("value", 0)
                  for n in ("tiling.units_written", "tiling.verify_rounds")}
        return blob, spans, counts

    was = obs.enabled()
    obs.enable()
    try:
        one = traced()
        cpu_mesh(monkeypatch, 2)
        two = traced()
    finally:
        (obs.enable if was else obs.disable)()
    assert one[0] == two[0] == one_card[codec][0]
    assert one[1] == two[1] and "span.tiling.verify_round" in one[1]
    assert one[2] == two[2] and one[2]["tiling.units_written"] == 32


def test_one_device_runs_on_the_caller_thread(monkeypatch, field, one_card):
    """With one card in the mesh no thread starts: the pool is never
    asked for."""
    u, v = field

    def no_pool(*args):
        raise AssertionError("a one-device mesh asked for a thread pool")
    monkeypatch.setattr(sharding, "host_pool", no_pool)
    blob, st = repro_torch.compress_tiled(
        u, v, repro_torch.CompressionConfig(eb=1e-2),
        repro_torch.TileGrid(*GRID), device="cpu")
    assert blob == one_card["host"][0]
    assert st["chunks"]["units"]["verify"] == [32]
    caller = threading.get_ident()
    seen = []

    def fn(items, card):
        seen.append((threading.get_ident(), card))
        return [x * 2 for x in items]
    assert sharding.map_cards(fn, [1, 2, 3], [CPU]) == ([2, 4, 6], [0] * 3)
    assert seen == [(caller, CPU)]


@pytest.mark.parametrize("n_dev", [2, 3, 4])
@pytest.mark.parametrize("n", [1, 3, 5])
def test_map_cards_keeps_item_order_on_ragged_splits(n_dev, n):
    items = [list(range(i + 1)) for i in range(n)]     # weights 1 .. n
    threads = {}

    def fn(part, card):
        threads.setdefault(threading.get_ident(), []).extend(part)
        return [sum(it) for it in part]
    results, slots = sharding.map_cards(fn, items, [CPU] * n_dev)
    assert results == [sum(it) for it in items]
    parts = sharding.deal([len(it) for it in items], n_dev)
    assert sorted(i for p in parts for i in p) == list(range(n))
    assert all(slots[i] == k for k, p in enumerate(parts) for i in p)
    assert len(set(slots)) == min(n, n_dev)
    assert threading.get_ident() not in threads


def test_deal_balances_by_weight_deterministically():
    # the chunk sizes of a 4 x 4-tile window: 4, four sides of 2, corners
    w = [4, 2, 2, 2, 2, 1, 1, 1, 1]
    assert sharding.deal(w, 2) == [[0, 3, 5, 7], [1, 2, 4, 6, 8]]
    assert sharding.deal(w, 2) == sharding.deal(list(w), 2)
    for n in (2, 3, 4):
        loads = [sum(w[i] for i in p) for p in sharding.deal(w, n)]
        assert max(loads) - min(loads) <= max(w)


def test_map_cards_raises_the_first_error_in_item_order():
    def fn(part, card):
        if 3 in part or 4 in part:
            raise KeyError(min(i for i in part if i in (3, 4)))
        return part

    with pytest.raises(KeyError, match="3"):
        sharding.map_cards(fn, list(range(8)), [CPU] * 3, weight=lambda i: 1)
    # two workers: [0, 2, 4, 6] raises 4, [1, 3, 5, 7] raises 3
    with pytest.raises(KeyError, match="4"):
        sharding.map_cards(fn, list(range(8)), [CPU] * 2, weight=lambda i: 1)


@pytest.mark.cuda
def test_tiles_devices_lists_every_card_own_first():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: tiles_devices lists the cards")
    n = torch.cuda.device_count()
    for k in range(n):
        got = sharding.tiles_devices(f"cuda:{k}")
        assert got[0] == torch.device("cuda", k)
        assert sorted(d.index for d in got) == list(range(n))
        assert all(d.type == "cuda" for d in got)
    assert sharding.tiles_devices("cuda")[0] == torch.device(
        "cuda", torch.cuda.current_device())
    assert sharding.tiles_devices("cpu") == [CPU]


def test_reference_map_tiles_padded_fails_on_ragged_batches():
    """ROADMAP Queue 3 item 14, a fault of the reference, not ported: on
    four host devices the reference's ``map_tiles_padded`` works on a
    batch the device count divides and raises jax's ShardingTypeError
    on a ragged one (the slice that drops its padding)."""
    code = textwrap.dedent("""
        import jax, jax.numpy as jnp
        from repro.parallel import sharding
        assert jax.device_count() == 4
        ok = sharding.map_tiles_padded(lambda r: r * 2,
                                       jnp.ones((4, 3), jnp.float32))
        assert ok.shape == (4, 3) and float(ok.sum()) == 24.0
        try:
            sharding.map_tiles_padded(lambda r: r * 2,
                                      jnp.ones((6, 3), jnp.float32))
        except Exception as e:
            print("RAISED", type(e).__name__)
        else:
            print("NO ERROR")
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    assert "RAISED ShardingTypeError" in r.stdout, r.stdout + r.stderr
