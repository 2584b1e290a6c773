"""The harness at CPU test sizes (bench/tests/tiny.py): cells run and
prove correct; a configuration, mix and metric added as new files are
picked up by name; a run refuses to start with JAX or the JAX package
loaded; the control (bench/control.py) and each fault a cell can have
come out not correct."""
import dataclasses
import json
import os
import sys
import types

import numpy as np
import pytest
import tiny
import torch

from bench import harness
from bench.control import PlainQuantizer

CELLS = ["mono-tiny.write", "mono-tiny.read", "tiled-tiny.write"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "traced"])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(root, cell, trace):
    result, checks = tiny.run(root, cell, trace=trace)
    assert result["correct"], result["checks"]
    if cell.startswith("tiled"):
        # the track index read back holds the decoded field's crossings
        assert checks["index_faces_differ"][0] == 0
    assert result["attempted"] >= 1 and result["failed"] == 0
    names = set(result["metrics"])
    if not trace:
        assert "setup_s" in names
        if cell.startswith("tiled"):
            # the tiled write's rate is a per-layer metric
            assert names == {"ratio", "setup_s"}
        else:
            assert names & {"encode_MBps", "decode_MBps"}
    else:
        # the span and counter readers read on the CPU; the device
        # readers find no device work and say nothing
        assert not names & {"device_idle_pct.write", "device_idle_pct.read",
                            "device_idle_pct.tiled",
                            "kernels_roofline.write"}
        if cell.startswith("mono-tiny.write"):
            assert {"fixpoint_ms.write", "verify_rounds.write",
                    "codec_ms.write"} <= names
        if cell.startswith("tiled"):
            assert {"encode_MBps.tiled", "tiling_fixpoint_ms.write",
                    "tiling_emit_ms.write"} <= names
            assert result["metrics"]["encode_MBps.tiled"]["value"] > 0
    assert list(result)[-1] == "checks"


def test_new_config_mix_and_metric_are_picked_up_by_name(root, tmp_path):
    work = tiny.make_root(tmp_path)
    before = {p: p.read_bytes() for p in (work / "bench").rglob("*")
              if p.is_file()}
    cfg = dict(tiny.TINY_CONFIGS["mono-tiny"],
               field={"generator": "heated_plume", "H": 20, "W": 18,
                      "seed": 4},
               chunk_frames=5)
    (work / "bench" / "configs" / "plume-mono.json").write_text(
        json.dumps(cfg))
    (work / "bench" / "mixes" / "write-one.json").write_text(json.dumps(
        {"op": "write", "loop": "closed", "pool_chunks": 1,
         "check_chunks": 1, "end": "call"}))
    (work / "bench" / "metrics" / "calls_in_window.write.py").write_text(
        "def read(ctx):\n    return float(len(ctx['calls']))\n")
    # a new op: a write whose check also reads the container's length
    (work / "bench" / "ops" / "write-sized.py").write_text(
        (work / "bench" / "ops" / "write.py").read_text()
        + "\n\n_check = check\n\n\ndef check(ctx):\n"
          "    out = _check(ctx)\n"
          "    out['empty_containers'] = (sum(not a for a in ctx['answers']"
          " if a is not None), 0, '<=')\n    return out\n")
    (work / "bench" / "mixes" / "write-sized.json").write_text(json.dumps(
        {"op": "write-sized", "loop": "closed", "pool_chunks": 1,
         "check_chunks": 1, "end": "call"}))
    bench = json.loads((work / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "plume-mono.write-one",
                               "config": "plume-mono",
                               "traffic": "write-one", "chips": 1,
                               "why": "test"})
    bench["workloads"].append({"name": "plume-mono.write-sized",
                               "config": "plume-mono",
                               "traffic": "write-sized", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "calls_in_window.write", "unit":
                               "calls", "better": "higher", "source":
                               "program_counter", "layer": "API",
                               "moves": "encode_MBps",
                               "workloads": ["plume-mono.write-one"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "mono-tiny.write" in m["workloads"]:
            m["workloads"] += ["plume-mono.write-one",
                               "plume-mono.write-sized"]
    (work / "BENCHMARK.json").write_text(json.dumps(bench))
    after = {p: p.read_bytes() for p in (work / "bench").rglob("*")
             if p.is_file() and p in before}
    assert after == before          # no file of the benchmark edited
    result, _ = tiny.run(work, "plume-mono.write-one", trace=True)
    assert result["correct"]
    assert result["metrics"]["calls_in_window.write"]["value"] >= 1
    result, _ = tiny.run(work, "plume-mono.write-one")
    assert {"encode_MBps", "ratio", "setup_s"} <= set(result["metrics"])
    result, checks = tiny.run(work, "plume-mono.write-sized")
    assert result["correct"] and checks["empty_containers"][0] == 0
    assert {"encode_MBps", "ratio", "setup_s"} <= set(result["metrics"])


@pytest.mark.parametrize("given,chips,shown", [
    (None, 1, "0"), (None, 4, "0,1,2,3"), ("0,1,2,3", 1, "0"),
    ("2,3", 1, "2"), ("3, 1,0,2", 4, "3,1,0,2"), ("1", 4, "1")])
def test_run_sees_the_first_cards_of_the_cell(monkeypatch, given, chips,
                                              shown):
    # a one-card cell on a machine that shows four uses one; a cell given
    # too few shows them all and is refused by the count
    if given is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", given)
    for k in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "REPRO_JIT_CACHE",
              "USE_FLAX"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(sys, "path", list(sys.path))
    harness.prepare_env({"chips": chips})
    assert os.environ["CUDA_VISIBLE_DEVICES"] == shown


@pytest.mark.parametrize("name", ["jax", "jaxlib", "flax", "repro",
                                  "repro.core", "jax.numpy"])
def test_refuses_with_jax_or_the_jax_package_loaded(monkeypatch, capsys,
                                                    name):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert name in harness.forbidden_modules()
    rc = harness.main(["--workload", "fs512-device.write", "--seed", "1",
                       "--seconds", "1"])
    assert rc != 0
    assert "forbidden" in capsys.readouterr().err


def test_port_name_is_not_the_jax_package(monkeypatch):
    for name in ("repro_torch", "repro_torch.core", "reprox", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_control_is_not_correct(root, cell, seed):
    result, checks = tiny.run(root, cell, seed=seed, program=PlainQuantizer)
    assert not result["correct"]
    # it keeps the pointwise bound and breaks the trajectories
    assert checks["max_err_over_eb"][0] <= 1.0
    assert checks["fc_t"][0] + checks["fc_s"][0] > 0


# ----------------------------------------------------------------------
# faults planted under the timed path (after the set-up's calls)
# ----------------------------------------------------------------------

class Faulty:
    """The program's compress / decompress with a fault from the
    ``after``-th call on (the set-up's calls run sound)."""

    def __init__(self, after, compress=None, decompress=None):
        from repro_torch.core import compressor

        self.c = compressor
        self.n = 0
        self.after = after
        self._compress = compress
        self._decompress = decompress

    def compress(self, u, v, cfg, device=None):
        self.n += 1
        if self._compress and self.n > self.after:
            return self._compress(self.c, u, v, cfg, device)
        return self.c.compress(u, v, cfg, device=device)

    def decompress(self, blob, backend=None, device=None):
        self.n += 1
        if self._decompress and self.n > self.after:
            return self._decompress(self.c, blob, device)
        return self.c.decompress(blob, device=device)


def half_frames_compress(c, u, v, cfg, device):
    # half of the batch left out: the first half of the frames written
    T = u.shape[0]
    return c.compress(u[: T // 2], v[: T // 2], cfg, device=device)


def half_frames_decompress(c, blob, device):
    u, v = c.decompress(blob, device=device)
    T = u.shape[0]
    u[T // 2:] = u[: T - T // 2].mean(axis=0)
    v[T // 2:] = v[: T - T // 2].mean(axis=0)
    return u, v


def altered_compress(c, u, v, cfg, device):
    # one value altered where it is produced: a container of a field
    # with one value moved by three bounds
    u = u.copy()
    u[1, 2, 3] += np.float32(3 * cfg.eb * float(u.max() - u.min()))
    return c.compress(u, v, cfg, device=device)


def altered_decompress(c, blob, device):
    u, v = c.decompress(blob, device=device)
    v = v.copy()
    v[-1, 1, 1] += np.float32(3.0 * (v.max() - v.min()))
    return u, v


@pytest.mark.parametrize("cell,fault", [
    ("mono-tiny.write", dict(compress=half_frames_compress)),
    ("tiled-tiny.write", dict(compress=half_frames_compress)),
    ("mono-tiny.read", dict(decompress=half_frames_decompress)),
    ("mono-tiny.write", dict(compress=altered_compress)),
    ("tiled-tiny.write", dict(compress=altered_compress)),
    ("mono-tiny.read", dict(decompress=altered_decompress)),
], ids=["write-half", "tiled-half", "read-half", "write-altered",
        "tiled-altered", "read-altered"])
def test_fault_is_not_correct(root, cell, fault):
    # set-up: one compress (write) or the pool's compresses and one
    # decompress (read, 2 chunks)
    after = 1 if cell.endswith("write") else 3
    result, _ = tiny.run(root, cell, program=Faulty(after, **fault))
    assert not result["correct"], result["checks"]


def test_state_left_unchanged_is_not_correct(root, monkeypatch):
    # the decoder's temporal recursion returns its input unchanged (the
    # residuals stand for the values): every read is wrong
    from repro_torch.core import backend

    real = backend.sl_decode
    n = {"calls": 0}

    def stuck(res_u, res_v, *args, **kw):
        n["calls"] += 1
        if n["calls"] <= 3:     # the set-up's compresses and decompress
            return real(res_u, res_v, *args, **kw)
        return res_u.clone(), res_v.clone()

    monkeypatch.setattr(backend, "sl_decode", stuck)
    result, _ = tiny.run(root, "mono-tiny.read")
    assert not result["correct"], result["checks"]


def test_exchange_between_cards_left_out_is_not_correct(root, monkeypatch):
    # two workers in the tiles mesh; the results of the second never
    # reach the caller once the set-up's call is done
    from repro_torch.parallel import sharding

    monkeypatch.setattr(sharding, "tiles_devices",
                        lambda d: [torch.device("cpu")] * 2)
    real = sharding.map_cards
    state = {"armed": False}

    def lossy(fn, items, devices, weight=len):
        out, slots = real(fn, items, devices, weight)
        if state["armed"]:
            out = [r if k == 0 else None for r, k in zip(out, slots)]
        return out, slots

    monkeypatch.setattr(sharding, "map_cards", lossy)

    class Arm(Faulty):
        def compress(self, u, v, cfg, device=None):
            self.n += 1
            state["armed"] = self.n > 1
            return self.c.compress(u, v, cfg, device=device)

    result, _ = tiny.run(root, "tiled-tiny.write", program=Arm(1))
    assert not result["correct"], result["checks"]
    assert result["failed"] >= 1


@pytest.mark.parametrize("fault", ["emptied", "unit_lost", "shifted",
                                   "no_index"])
def test_track_index_fault_is_not_correct(root, monkeypatch, fault):
    # the track index the tiled writer stores goes wrong where it is
    # built, once the set-up's call is done; the field stays sound
    from repro_torch.analysis import index
    from repro_torch.core import compressor, grid

    real = index.TrackIndexBuilder.add_unit
    state = {"armed": False, "n": 0}
    H, W = tiny.TINY_CONFIGS["tiled-tiny"]["field"]["H"], \
        tiny.TINY_CONFIGS["tiled-tiny"]["field"]["W"]
    F = sum(grid.face_family_sizes(H, W))

    def add_unit(self, key, seg_fid, seg_cell, node_fid, node_pos,
                 node_type):
        if state["armed"]:
            state["n"] += 1
            seg_fid = np.asarray(seg_fid, np.int64).reshape(-1, 2)
            node_fid = np.asarray(node_fid, np.int64)
            if fault == "emptied" or (fault == "unit_lost"
                                      and state["n"] % 2):
                seg_fid, seg_cell = seg_fid[:0], np.asarray(seg_cell)[:0]
                node_fid, node_pos = node_fid[:0], np.asarray(node_pos)[:0]
                node_type = np.asarray(node_type)[:0]
            elif fault == "shifted":    # every face one frame later
                seg_fid, node_fid = seg_fid + F, node_fid + F
        return real(self, key, seg_fid, seg_cell, node_fid, node_pos,
                    node_type)

    monkeypatch.setattr(index.TrackIndexBuilder, "add_unit", add_unit)

    class Arm(Faulty):
        def compress(self, u, v, cfg, device=None):
            self.n += 1
            state["armed"] = self.n > 1
            if state["armed"] and fault == "no_index":
                cfg = dataclasses.replace(cfg, track_index=False)
            return compressor.compress(u, v, cfg, device=device)

    result, checks = tiny.run(root, "tiled-tiny.write", program=Arm(1))
    assert state["n"] > 0 or fault == "no_index"
    assert checks["fc_t"][0] == 0 and checks["fc_s"][0] == 0
    assert checks["index_faces_differ"][0] != 0
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
def test_tiny_cells_correct_on_the_card(root):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for cell in CELLS:
        result, _ = harness.run(cell, 5, 0.0, False, 0.0, root=root,
                                device="cuda")
        assert result["correct"], (cell, result["checks"])
