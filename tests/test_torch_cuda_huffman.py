"""K6 (csrc/huffman.cu), the card's decode of the device codec's Huffman
sections: the host decode's symbols, or its ContainerError, on every
case of tests/huffman_cases.py, its plain version's outputs bit for bit,
both streams of a 64x512x512 container of the benchmark's fs512-device
field, and ``decompress`` on the card == on the CPU, monolithic and
tiled, with K6 launched.

Needs a CUDA device and nvcc; elsewhere it skips with the reason.  The
file imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q --noconftest \\
        tests/test_torch_cuda_huffman.py
"""
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

import numpy as np
import torch

import repro_torch
from huffman_cases import CASES, host_decode, huff_sections, padded, tables
from repro_torch import obs
from repro_torch.core import encode, entropy
from repro_torch.data import synthetic
from repro_torch.kernels.entropy import kernel as k6
from repro_torch.kernels.entropy import ref

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_equals_host(dev, ln, data, n):
    want, err = host_decode(ln, data, n)
    ln32 = np.asarray(ln, np.int32)
    before = k6.huffman_decode.launches
    if err is not None:
        with pytest.raises(err):
            entropy.decode_on(dev, ln32, data, n)
    else:
        got = entropy.decode_on(dev, ln32, data, n)
        assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert k6.huffman_decode.launches == before + 1


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_equals_host_and_plain(dev, name):
    ln, data, n = CASES[name]()
    _card_equals_host(dev, ln, data, n)
    tab, fill = tables(ln)
    tab = torch.as_tensor(tab)
    stream = padded(data)
    sym, status = k6.huffman_decode(stream.to(dev), tab.to(dev),
                                    8 * len(data), n, fill)
    torch.cuda.synchronize()
    r_sym, r_status = ref.huffman_decode(stream, tab, 8 * len(data), n, fill)
    assert torch.equal(sym.cpu(), r_sym) and torch.equal(status.cpu(),
                                                          r_status)


def test_fs512_chunk_streams(dev):
    """Both Huffman sections of the first 64x512x512 chunk of the
    fs512-device configuration (the read cell's containers)."""
    sys.path.insert(0, str(ROOT))
    from bench import harness

    config = harness.load_json(ROOT / "bench" / "configs" / "fs512-device.json")
    (u, v), = harness.make_pool(config, {"pool_chunks": 1}, dev)
    blob, _ = repro_torch.compress(u, v, harness.compression_config(config),
                                   device=dev)
    secs = huff_sections(blob)
    assert [s[0] for s in secs] == ["sym_u", "sym_v"]
    for _, ln, data, n in secs:
        assert n == 64 * 512 * 512
        _card_equals_host(dev, ln, data, n)


@pytest.mark.parametrize("tiled", [False, True])
def test_decompress_card_equals_cpu(dev, tiled):
    T, H, W = 8, 64, 96
    u, v = synthetic.vortex_street(T=T, H=H, W=W)
    cfg = repro_torch.CompressionConfig(
        eb=1e-2, codec="device", dt=0.05, dx=2.0 / (W - 1), dy=1.0 / (H - 1),
        tiling=repro_torch.TileGrid(32, 48, 4) if tiled else None)
    blob, _ = repro_torch.compress(u, v, cfg, device=dev)
    assert blob[:5] == (encode.MAGIC_TILED if tiled else encode.MAGIC_HUF)
    was = obs.enabled()
    obs.enable()
    try:
        c0 = obs.snapshot().get("decode.huffman_card", {"value": 0})["value"]
        before = k6.huffman_decode.launches
        card = repro_torch.decompress(blob, device=dev)
        c1 = obs.snapshot()["decode.huffman_card"]["value"]
    finally:
        (obs.enable if was else obs.disable)()
    # two streams a field (tiled: a unit)
    units = len(encode.tiled_header(blob)["units"]) if tiled else 1
    assert k6.huffman_decode.launches - before == 2 * units
    assert c1 - c0 == 2 * units
    cpu = repro_torch.decompress(blob, device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(card, cpu))


def _damaged(blob, what):
    payload = blob[5:]
    hlen = int.from_bytes(payload[:4], "little")
    header = encode._msgpack.unpackb(payload[4: 4 + hlen])
    meta = header["sections"]["sym_u"]
    if what == "kraft":
        bad = np.zeros(256, np.uint8)
        bad[:4] = 1                           # four 1-bit codes: Kraft 2
        meta["lengths"] = bad.tobytes()
    elif what == "max length":
        meta["lengths"] = np.full(256, 31, np.uint8).tobytes()
    elif what == "table size":
        meta["lengths"] = b"\x08" * 255
    else:                                     # the bitstream cut in half
        meta["len"] //= 2
    hdr = encode._msgpack.packb(header)
    return (encode.MAGIC_HUF + len(hdr).to_bytes(4, "little") + hdr
            + payload[4 + hlen:])


@pytest.mark.parametrize("what", ["kraft", "max length", "table size",
                                  "cut stream"])
def test_damaged_container_raises_on_the_card(dev, what):
    """Damaged sections of a container of 4 x 16 x 16 (n < 2048: the host
    raises once a symbol starts past the cut) raise ContainerError on the
    card as on the host."""
    u, v = synthetic.vortex_street(T=4, H=16, W=16)
    cfg = repro_torch.CompressionConfig(eb=1e-2, codec="device", dt=0.05,
                                        dx=2.0 / 15, dy=1.0 / 15)
    blob = _damaged(repro_torch.compress(u, v, cfg, device=dev)[0], what)
    for d in ("cpu", dev):
        with pytest.raises(encode.ContainerError):
            encode.unpack(blob, d)
        with pytest.raises(encode.ContainerError):
            repro_torch.decompress(blob, device=d)
