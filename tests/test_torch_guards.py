"""Guards of the PyTorch port: it imports no JAX and nothing of the JAX
package, it runs on CUDA unless asked for the CPU, and it refuses the
options whose code paths are not ported."""
import pytest

pytest.importorskip("torch")

import io
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import repro_torch
from repro_torch.data import synthetic

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
_BAD_IMPORT = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b"
                         r"|from\s+repro\b|import\s+repro\.|from\s+repro\.)",
                         re.MULTILINE)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_no_jax_nor_reference(path):
    src = path.read_text()
    assert not _BAD_IMPORT.search(src), f"{path} imports jax or repro"


def test_port_runs_without_jax():
    """With ``jax`` unimportable the port still imports, round-trips a
    field, serves a SMOKE model, trains one and dry-runs one on the
    CPU."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import numpy as np, repro_torch\n"
        "from repro_torch.data import synthetic\n"
        "u, v = synthetic.double_gyre(T=3, H=8, W=10)\n"
        "blob, st = repro_torch.compress(u, v, device='cpu')\n"
        "ur, vr = repro_torch.decompress(blob, device='cpu')\n"
        "assert np.abs(ur.astype(np.float64) - u).max() <= st['eb_abs']\n"
        "import repro_torch.configs as C\n"
        "from repro_torch.launch import serve\n"
        "from repro_torch.models import convert, transformer\n"
        "assert len(C.all_archs()) == 10\n"
        "out = serve.run(serve.parse_args(['--arch', 'yi_6b', '--smoke',\n"
        "    '--requests', '1', '--batch', '1', '--gen-len', '2',\n"
        "    '--device', 'cpu']))\n"
        "assert out['tokens'][0].shape == (2,)\n"
        "import contextlib, io\n"
        "from repro_torch.launch import train\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    res = train.run(train.parse_args(['--smoke', '--steps', '2',\n"
        "        '--device', 'cpu']))\n"
        "assert len(res['losses']) == 2\n"
        "from repro_torch.configs import CellSpec\n"
        "from repro_torch.launch import dryrun\n"
        "m = type('M', (), {'CONFIG': C.get('qwen1_5_0_5b').SMOKE,\n"
        "    'CELLS': {'d': CellSpec('decode', 8, 1, cache_len=8)}})\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    row = dryrun.lower_cell(m, 'd', dryrun.card_mesh(), 'card',\n"
        "                            'cpu')\n"
        "assert row['status'] == 'ok'\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               or m == 'repro' for m in sys.modules\n"
        "               if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def field():
    return synthetic.double_gyre(T=3, H=8, W=10)


def test_default_device_needs_cuda(no_cuda, field):
    u, v = field
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.compress(u, v)
    blob, _ = repro_torch.compress(u, v, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.decompress(blob)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.compress(u, v, device="cuda")


def test_stream_and_read_entry_points_need_cuda(no_cuda, field):
    from repro_torch import analysis
    from repro_torch.core import fixedpoint

    u, v = field
    vr = (float(min(u.min(), v.min())), float(max(u.max(), v.max())))
    grid = repro_torch.TileGrid(4, 4, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.compress_stream(zip(u, v), repro_torch.CompressionConfig(),
                                    grid, value_range=vr)
    blob, _ = repro_torch.compress_stream(
        zip(u, v), repro_torch.CompressionConfig(), grid, value_range=vr,
        device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.decompress_tiled(blob, degraded=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        analysis.decode_for_track(blob, 0)
    _, ufp, vfp = fixedpoint.to_fixed(u, v)
    with pytest.raises(RuntimeError, match="CUDA"):
        analysis.extract(ufp, vfp)
    with pytest.raises(RuntimeError, match="CUDA"):
        analysis.TrackIndexBuilder(grid)
    assert analysis.TrackIndexBuilder(grid, "cpu").device.type == "cpu"


@pytest.mark.parametrize("kw,exc,match", [
    # the JAX package's backend names run (tests/test_torch_sl_steppers.py)
    (dict(backend="cuda"), ValueError, "backend"),
    (dict(tiling=repro_torch.TileGrid(halo=0)), ValueError, "halo"),
    (dict(codec="device", tiling=repro_torch.TileGrid(thalo=0)), ValueError,
     "thalo"),
    (dict(codec="gzip"), ValueError, "codec"),
    # the legacy binding runs (tests/test_torch_legacy.py) and checks
    # the config as the fused one does
    (dict(fused=False, codec="gzip"), ValueError, "codec"),
    (dict(eb_policy=object()), TypeError, "eb_policy"),
])
def test_unported_config_refused(field, kw, exc, match):
    u, v = field
    with pytest.raises(exc, match=match):
        repro_torch.compress(u, v, repro_torch.CompressionConfig(**kw),
                             device="cpu")


def test_backend_names_select_the_sl_stepper(field):
    """The JAX package's backend names run: each writes its tag, None and
    "numpy" the same bytes; "numpy" keeps to the plain versions on the
    CPU, so it refuses a CUDA device (as REPRO_BACKEND=numpy does)."""
    from repro_torch.core import compressor, encode

    u, v = field
    default = repro_torch.compress(u, v, device="cpu")[0]
    for name in ("numpy", "xla", "pallas"):
        cfg = repro_torch.CompressionConfig(backend=name)
        blob, _ = repro_torch.compress(u, v, cfg, device="cpu")
        assert encode.unpack(blob)[0]["sl_backend"] == name
        assert (blob == default) == (name == "numpy")
        compressor.refuse_plain_on_card(cfg, torch.device("cpu"))
    with pytest.raises(ValueError, match='device="cpu"'):
        compressor.refuse_plain_on_card(
            repro_torch.CompressionConfig(backend="numpy"),
            torch.device("cuda"))
    compressor.refuse_plain_on_card(repro_torch.CompressionConfig(),
                                    torch.device("cuda"))


def test_streaming_and_degraded_reads_refused(field):
    """Streaming and degraded reads run (ROADMAP item 8); what stays
    refused: resume without a path sink (the journal lives next to the
    container)."""
    u, v = field
    vr = (float(min(u.min(), v.min())), float(max(u.max(), v.max())))
    with pytest.raises(ValueError, match="path"):
        repro_torch.compress_stream(zip(u, v), repro_torch.CompressionConfig(),
                                    repro_torch.TileGrid(4, 4, 2),
                                    value_range=vr, sink=io.BytesIO(),
                                    resume=True, device="cpu")


def test_uniform_policy_spellings_accepted(field):
    from repro_torch.core.ebpolicy import UniformPolicy

    u, v = field
    blobs = {repro_torch.compress(u, v, repro_torch.CompressionConfig(
        eb_policy=p), device="cpu")[0] for p in (None, "uniform",
                                                UniformPolicy())}
    assert len(blobs) == 1


def test_relative_mode_degenerate_range():
    u = np.ones((2, 4, 4), np.float32)
    with pytest.raises(repro_torch.DegenerateRangeError):
        repro_torch.compress(u, u, device="cpu")
