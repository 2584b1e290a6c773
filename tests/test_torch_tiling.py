"""The port's tiled containers against the JAX package (CPU).

``repro_torch.compress_tiled(..., device="cpu")`` must write the bytes
``repro.core.compress_tiled(..., backend="numpy")`` writes for the same
field, config and grid: CPTT1 version 4 (host codec), 5 (device codec)
and 6 (adaptive policy), with and without the track index, with and
without ``batch_units``.  Blobs cross-decode in both directions, a tiled
decode equals the monolithic decode bitwise, a region decode reads only
the units ``read_plan`` names, and the checked-in version-3 tiled golden
decodes bitwise.  The unit-batched plain versions equal a loop of the
single-unit ones.  All comparisons are exact.
"""
import os
import zlib

import msgpack
import numpy as np
import pytest
import torch

import repro.core as core
from repro.core import backend as r_backend
from repro.core import ebpolicy as r_ebpolicy
from repro.core import tiling as r_tiling
from repro import obs as r_obs
import repro_torch
from repro_torch import obs
from repro_torch.analysis import query
from repro_torch.core import (_msgpack, backend, ebound, ebpolicy, encode,
                              mop, quantize, tiling, trajectory)
from repro_torch.data import synthetic
from repro_torch.kernels.cptest import ref as r2
from repro_torch.kernels.lorenzo import ref as r1
from repro_torch.kernels.semilagrange import ref as r3

_DATA = os.path.join(os.path.dirname(__file__), "data")
# 4x4 tiles a window, 2 windows: per window 4 interior tiles share a
# signature, each side's 2 edge tiles another; the 4 corners are alone
GRID = (6, 8, 3)
CASES = {
    "host": dict(eb=1e-2),
    "device": dict(eb=1e-2, codec="device"),
    "no-index": dict(eb=1e-2, track_index=False),
}


def _policy_kw(mod):
    pol = mod.TilePolicy.make(3, 10, 14, default=1e-2,
                              values={(0, 0, 0): 2e-3, (1, 1, 1): 5e-3})
    return dict(eb=1e-2, eb_policy=pol, n_levels=mod.levels_for(pol))


@pytest.fixture(scope="module")
def field():
    return synthetic.double_gyre(T=6, H=20, W=28)


@pytest.fixture(scope="module")
def ref_blobs(field):
    """The JAX package's containers of every case (numpy SL stepper)."""
    u, v = field
    cases = dict(CASES, adaptive=_policy_kw(r_ebpolicy))
    return {name: r_tiling.compress_tiled(
        u, v, core.CompressionConfig(backend="numpy", **kw),
        r_tiling.TileGrid(*GRID))[0] for name, kw in cases.items()}


def _port_kw(name):
    return _policy_kw(ebpolicy) if name == "adaptive" else CASES[name]


def _port(field, name, **extra):
    u, v = field
    cfg = repro_torch.CompressionConfig(**_port_kw(name), **extra)
    return tiling.compress_tiled(u, v, cfg, tiling.TileGrid(*GRID),
                                 device="cpu")


@pytest.mark.parametrize("batch_units", [True, False])
@pytest.mark.parametrize("name", ["host", "device", "no-index", "adaptive"])
def test_port_bytes_equal_reference(field, ref_blobs, name, batch_units):
    blob, st = _port(field, name, batch_units=batch_units)
    assert blob == ref_blobs[name]
    hdr = encode.tiled_header(blob)
    assert hdr["version"] == {"host": 4, "device": 5, "no-index": 4,
                              "adaptive": 6}[name]
    assert (encode.TRACK_INDEX_KEY in hdr) == (name != "no-index")
    assert st["n_units"] == len(hdr["units"]) == 32
    assert st["verify_rounds"] == 0
    want = dict(multi=10, single=8) if batch_units else dict(multi=0,
                                                             single=32)
    for stage in ("verify", "emit"):
        assert {k: st["chunks"][stage][k] for k in want} == want


def test_compress_routes_tiling_and_decompress_reads_cptt(field, ref_blobs):
    u, v = field
    cfg = repro_torch.CompressionConfig(tiling=repro_torch.TileGrid(*GRID),
                                        **CASES["host"])
    blob, st = repro_torch.compress(u, v, cfg, device="cpu")
    assert blob == ref_blobs["host"] and st["pipeline"] == "tiled"
    ur, vr = repro_torch.decompress(blob, device="cpu")
    wr = repro_torch.decompress_tiled(blob, device="cpu")
    assert np.array_equal(ur, wr[0]) and np.array_equal(vr, wr[1])


@pytest.mark.parametrize("name", ["host", "device", "adaptive"])
def test_cross_decode_both_ways(ref_blobs, name):
    """Port blobs are the reference's bytes, so one decode per package
    covers both directions."""
    blob = ref_blobs[name]
    pu, pv = tiling.decompress_tiled(blob, device="cpu")
    ru, rv = r_tiling.decompress_tiled(blob)
    assert np.array_equal(pu, ru) and np.array_equal(pv, rv)


@pytest.mark.parametrize("name", ["host", "device", "adaptive"])
def test_tiled_decode_equals_monolithic_decode(field, ref_blobs, name):
    u, v = field
    mono, st = repro_torch.compress(
        u, v, repro_torch.CompressionConfig(**_port_kw(name)), device="cpu")
    mu, mv = repro_torch.decompress(mono, device="cpu")
    tu, tv = repro_torch.decompress(ref_blobs[name], device="cpu")
    assert np.array_equal(tu, mu) and np.array_equal(tv, mv)
    fc = trajectory.false_cases(u, v, tu, tv, st["scale"])
    assert fc["FC_t"] == 0 and fc["FC_s"] == 0


@pytest.mark.parametrize("region", [(0, 6, 0, 20, 0, 28), (1, 4, 5, 13, 7, 9),
                                    (3, 4, 19, 20, 27, 28)])
def test_region_decode_reads_only_planned_units(ref_blobs, region):
    blob = ref_blobs["host"]
    fu, fv = repro_torch.decompress(blob, device="cpu")
    src = query.ContainerSource(blob)
    src.header()
    reads = src.reads
    ru, rv = repro_torch.decompress_region(src, region, device="cpu")
    plan = repro_torch.read_plan(blob, region)
    assert src.reads - reads == len(plan) >= 1
    assert plan == r_tiling.read_plan(blob, region)
    t0, t1, i0, i1, j0, j1 = region
    assert np.array_equal(ru, fu[t0:t1, i0:i1, j0:j1])
    assert np.array_equal(rv, fv[t0:t1, i0:i1, j0:j1])


def test_region_decode_from_a_path(ref_blobs, tmp_path):
    path = tmp_path / "field.cptt"
    path.write_bytes(ref_blobs["device"])
    region = (2, 5, 0, 7, 9, 20)
    got = repro_torch.decompress_region(str(path), region, device="cpu")
    want = r_tiling.decompress_region(ref_blobs["device"], region)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_golden_v3_tiled_blob_decodes_bitwise():
    """A version-3 container of the JAX package's "xla" SL stepper (no
    preambles, no CRCs): the port's f64 stepper replays it exactly."""
    with open(os.path.join(_DATA, "golden_v3_tiled.cptt"), "rb") as f:
        blob = f.read()
    exp = np.load(os.path.join(_DATA, "golden_v3_expected.npz"))
    hdr = encode.tiled_header(blob)
    assert hdr["version"] == 3 and hdr["sl_backend"] == "xla"
    assert all("crc" not in e for e in hdr["units"])
    ur, vr = repro_torch.decompress(blob, device="cpu")
    assert np.array_equal(ur, exp["ur"]) and np.array_equal(vr, exp["vr"])


def test_future_version_refused():
    w = encode.TiledWriter()
    w.add_unit((0, 0, 0), (0, 1, 0, 1, 0, 1), {"box": [0, 1, 0, 1, 0, 1]},
               {"sym_u": np.zeros(1, np.uint8)})
    blob = w.finish({"version": 99, "shape": [2, 2, 2]})
    with pytest.raises(ValueError, match="version 99"):
        repro_torch.decompress(blob, device="cpu")


def test_flipped_byte_in_unit_frame_raises_checksum_error(ref_blobs):
    blob = bytearray(ref_blobs["host"])
    entry = encode.tiled_header(bytes(blob))["units"][5]
    blob[entry["off"] + entry["len"] // 2] ^= 0x10
    with pytest.raises(encode.ChecksumError, match="checksum"):
        repro_torch.decompress(bytes(blob), device="cpu")
    with pytest.raises(encode.ChecksumError):
        encode.read_tiled_unit(bytes(blob), entry)


@pytest.mark.parametrize("grid,match", [(dict(halo=0), "halo"),
                                        (dict(thalo=0), "thalo"),
                                        (dict(tile_h=0), "sizes")])
def test_bad_grid_refused(field, grid, match):
    u, v = field
    with pytest.raises(ValueError, match=match):
        repro_torch.compress_tiled(u, v, repro_torch.CompressionConfig(),
                                   repro_torch.TileGrid(**grid), device="cpu")


def test_footer_is_msgpack_python_bytes(ref_blobs):
    """The footer (lists of dicts, nested dicts, the index's bin
    payloads) is what msgpack-python writes, in the reference's key
    order."""
    blob = ref_blobs["adaptive"]
    m = len(encode.MAGIC_TILED)
    (hlen,) = np.frombuffer(blob[-m - 4:-m], "<u4")
    raw = zlib.decompress(blob[len(blob) - m - 4 - int(hlen):-m - 4])
    hdr = encode.tiled_header(blob)
    assert _msgpack.packb(hdr) == msgpack.packb(hdr, use_bin_type=True) == raw
    assert _msgpack.unpackb(raw) == msgpack.unpackb(raw, raw=False)


def test_msgpack_writer_equals_msgpack_python_on_footer_types():
    rng = np.random.default_rng(0)
    obj = {"units": [{"key": [0, 1, 2], "box": [0, 3, 0, 6, 0, 8],
                      "off": 2 ** 33, "len": 70000, "crc": 2 ** 32 - 1}
                     for _ in range(20)],
           "tiling": {"tile_h": 6, "tile_w": 8, "window_t": 3, "halo": 1,
                      "thalo": 1},
           "arrays": {f"a{i}": {"dtype": "float64", "shape": [i, 3],
                                "data": rng.bytes(8 * i * 3)}
                      for i in (0, 1, 11, 3000)},
           "neg": [-1, -33, -129, -40000, -2 ** 40], "f": [0.5, -1e300],
           "s": "x" * 40, "b": b"\x00" * 300, "t": True, "n": None,
           "many": {str(i): i for i in range(20)}}
    assert _msgpack.packb(obj) == msgpack.packb(obj, use_bin_type=True)


def test_not_ported_options_name_item_8(field, ref_blobs, tmp_path):
    """Item 8 (streaming, salvage) is ported: salvage of a whole
    container keeps every unit, and what a stream still refuses is
    autotune (item 11) and resume without a path sink or a value
    range."""
    u, v = field
    blob, rep = encode.salvage_container(ref_blobs["host"])
    assert rep["units_recovered"] == 32 and rep["units_dropped"] == 0
    assert np.array_equal(repro_torch.decompress(blob, device="cpu")[0],
                          repro_torch.decompress(ref_blobs["host"],
                                                 device="cpu")[0])
    with pytest.raises(NotImplementedError, match="item 11"):
        tiling.compress_stream(iter([]), autotune=True, device="cpu")
    with pytest.raises(ValueError, match="path"):
        tiling.compress_stream(zip(u, v), value_range=(-1.0, 1.0),
                               resume=True, device="cpu")
    with pytest.raises(ValueError, match="value_range"):
        tiling.compress_stream(zip(u, v), sink=str(tmp_path / "c.cptt"),
                               resume=True, device="cpu")


# ----------------------------------------------------------------------
# the unit-batched plain versions == a loop of the single-unit ones
# ----------------------------------------------------------------------

OWNED = {"interior": (1, 1, 1, 3, 6, 8), "edge": (0, 0, 0, 3, 6, 8)}


def _unit_inputs(B, ext, xi_unit, seed):
    rng = np.random.default_rng(seed)
    shape = (B,) + ext
    eb = torch.as_tensor(rng.integers(0, 6 * xi_unit, shape))
    k, ll = quantize.quantize_eb(eb, xi_unit, 3)
    ufp = torch.as_tensor(rng.integers(-5000, 5000, shape))
    vfp = torch.as_tensor(rng.integers(-5000, 5000, shape))
    return ufp, vfp, k, ll


@pytest.mark.parametrize("block", [16, 13, 2])
@pytest.mark.parametrize("kind", ["interior", "edge"])
def test_lorenzo_units_plain_equals_unit_loop(kind, block):
    owned = OWNED[kind]
    ext = (4, 8, 10) if kind == "interior" else (4, 7, 9)
    ufp, vfp, k, ll = _unit_inputs(3, ext, 7, seed=block)
    got = r1.lorenzo_residual_units(ufp, vfp, k, ll, 7, block, owned)
    o = (slice(owned[0], owned[0] + owned[3]),
         slice(owned[1], owned[1] + owned[4]),
         slice(owned[2], owned[2] + owned[5]))
    for b in range(3):
        _, _, xu, xv = r1.lorenzo_residual(ufp[b], vfp[b], k[b], ll[b], 7,
                                           block, True)
        ru, rv = r1.lorenzo_residual(*(x[b][o] for x in (ufp, vfp, k, ll)),
                                     7, block)
        for g, w in zip(got, (ru, rv, xu, xv)):
            assert torch.equal(g[b], w)


def _verify_inputs(B, shape, seed, delta):
    rng = np.random.default_rng(seed)
    T, H, W = shape
    ufp = torch.as_tensor(rng.integers(-3, 4, (B,) + shape))
    vfp = torch.as_tensor(rng.integers(-3, 4, (B,) + shape))
    ur = ufp + torch.as_tensor(rng.integers(-1, 2, (B,) + shape))
    vr = vfp + torch.as_tensor(rng.integers(-1, 2, (B,) + shape))
    preds = [trajectory.face_predicate_tables(ufp[b], vfp[b])
             for b in range(B)]
    slice0 = torch.as_tensor(np.stack([p["slice"] for p in preds]))
    slab0 = torch.as_tensor(np.stack([p["slab"] for p in preds]))
    forced = torch.as_tensor(rng.random((B,) + shape) < 0.05)
    d = torch.as_tensor(rng.random((B,) + shape) < 0.1) if delta else None
    return ur, vr, ufp, vfp, d, slice0, slab0, forced


@pytest.mark.parametrize("delta", [False, True])
def test_verify_faces_units_plain_equals_unit_loop(delta):
    from repro_torch.core import grid

    ur, vr, ufp, vfp, d, slice0, slab0, forced = _verify_inputs(
        3, (4, 7, 9), 5, delta)
    tabs = grid.device_tables(7, 9, "cpu")
    got_forced = forced.clone()
    n = r2.verify_faces_units(ur, vr, ufp, vfp, d, tabs["slice"],
                              tabs["slab"], slice0, slab0, got_forced)
    total = 0
    for b in range(3):
        want = forced[b].clone()
        total += int(r2.verify_faces(
            ur[b], vr[b], ufp[b], vfp[b], None if d is None else d[b],
            tabs["slice"], tabs["slab"], slice0[b], slab0[b], want))
        assert torch.equal(got_forced[b], want)
    assert int(n) == total > 0


@pytest.mark.parametrize("block", [16, 4])
def test_sl_decode_units_plain_equals_unit_loop(block):
    rng = np.random.default_rng(block)
    B, T, H, W = 3, 5, 9, 11
    res_u = torch.as_tensor(rng.integers(-40, 40, (B, T, H, W)))
    res_v = torch.as_tensor(rng.integers(-40, 40, (B, T, H, W)))
    nb = (B, T, -(-H // block), -(-W // block))
    bms = rng.random(nb) < 0.5
    bms[:, 0] = False
    bms[1] = False                       # a unit with no SL frame at all
    bms[2, 2] = False                    # and one with a Lorenzo-only frame
    xu, xv = backend.sl_decode_units(res_u, res_v, bms, block, 0.5, 0.3,
                                     0.2, 2.0, 32)
    for b in range(B):
        wu, wv = backend.sl_decode(res_u[b], res_v[b], bms[b], block, 0.5,
                                   0.3, 0.2, 2.0, 32)
        assert torch.equal(xu[b], wu) and torch.equal(xv[b], wv)
    flags = np.zeros((B, T), np.uint8)
    c2 = [torch.zeros((B, T, H, W), dtype=torch.int64)] * 2
    got = r3.sl_decode_units(*c2, res_u, res_v,
                             torch.as_tensor(bms.astype(np.uint8)),
                             torch.as_tensor(flags), block, 0.5, 0.3, 0.2,
                             2.0, 32)
    assert all(torch.equal(g, torch.zeros_like(g)) for g in got)


def test_select_and_eb_derive_units_equal_unit_loop():
    rng = np.random.default_rng(2)
    B, T, H, W = 3, 4, 20, 19
    r = [torch.as_tensor(rng.integers(-60, 60, (B, T, H, W)))
         for _ in range(4)]
    got = mop.select_units(*r, 8)
    for b in range(B):
        assert torch.equal(got[b], mop.select(*(x[b] for x in r), 8))
    ufp = torch.as_tensor(rng.integers(-30, 30, (B, T, 6, 7)))
    vfp = torch.as_tensor(rng.integers(-30, 30, (B, T, 6, 7)))
    eb, sl, sb = ebound.derive_vertex_eb_units(ufp, vfp, 9)
    for b in range(B):
        want = ebound.derive_vertex_eb(ufp[b].clone(), vfp[b].clone(), 9)
        assert all(torch.equal(g[b], w) for g, w in zip((eb, sl, sb), want))


@pytest.mark.parametrize("H,W", [(5, 7), (12, 9)])
def test_mesh_tables_equal_reference(H, W):
    """The tet-face enumeration and global face ids the track index is
    keyed on, and the order-isomorphic sub-box ids."""
    from repro.core import grid as r_grid
    from repro_torch.core import grid

    assert np.array_equal(grid.TET_FACES, r_grid.TET_FACES)
    assert np.array_equal(grid.slab_tets(H, W), r_grid.slab_tets(H, W))
    fam, idx = grid.tet_face_map(H, W)
    r_fam, r_idx = r_grid.tet_face_map(H, W)
    assert np.array_equal(fam, r_fam) and np.array_equal(idx, r_idx)
    t = np.arange(fam.shape[0]) % 3
    fids = grid.tet_face_fids(fam, idx, t[:, None], H, W)
    assert np.array_equal(fids, r_grid.tet_face_fids(fam, idx, t[:, None],
                                                     H, W))
    flat = np.unique(fids)
    assert np.array_equal(grid.face_vertices(flat, H, W),
                          r_grid.face_vertices(flat, H, W))
    box = (1, 3, 2, 5, 1, 6)
    ids = grid.box_vertex_ids((4, H, W), box)
    assert np.array_equal(ids, r_grid.box_vertex_ids((4, H, W), box))
    assert (np.diff(ids.reshape(-1)) > 0).all()


def test_lemma1_violation_raises():
    crossed = np.zeros((2, 5, 4), bool)
    crossed[0, 1, :2] = True                 # a tet crossed twice: fine
    trajectory.check_lemma1(crossed, t_lo=7)
    crossed[1, 3, :3] = True                 # three crossed faces
    with pytest.raises(trajectory.Lemma1ViolationError, match="slab 8"):
        trajectory.check_lemma1(crossed, t_lo=7)


def test_host_map_keeps_order_and_raises_first_error():
    from repro_torch.parallel import sharding

    pool = sharding.host_pool("test")
    assert sharding.host_map(pool, lambda x: x * x, range(10)) == \
        [x * x for x in range(10)]

    def boom(x):
        if x in (3, 7):
            raise KeyError(x)
        return x
    with pytest.raises(KeyError, match="3"):
        sharding.host_map(pool, boom, range(10))


@pytest.mark.parametrize("seed", range(4))
def test_connected_labels_equal_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 400))
    edges = rng.integers(0, n, (int(rng.integers(0, 3 * n)), 2))
    want = np.asarray(r_backend.connected_labels(n, edges, backend="numpy"))
    got = backend.connected_labels(n, torch.as_tensor(edges))
    assert np.array_equal(got.numpy(), want)


# ----------------------------------------------------------------------
# rate accounting and tracing of the tiled path
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["host", "device"])
def test_run_report_tiled_sums_to_container(ref_blobs, name):
    blob = ref_blobs[name]
    rep = obs.run_report(blob)
    assert rep["container"] == "CPTT1" and rep["n_units"] == 32
    assert sum(rep["bytes_by_kind"].values()) == len(blob) \
        == rep["kind_bytes_total"]
    assert rep == r_obs.run_report(blob)


def _spans(mod):
    return {k[len("span."):]: v["count"] for k, v in mod.snapshot().items()
            if k.startswith("span.tiling.") or k == "span.entropy.encode_streams"}


def _tiled_counters(mod):
    snap = mod.snapshot()
    out = {k: snap[k]["value"] for k in ("tiling.verify_rounds",
                                         "tiling.units_written") if k in snap}
    h = snap.get("pipeline.batch_group_size")
    out["groups"] = (h["count"], h["sum"]) if h else (0, 0)
    return out


@pytest.mark.parametrize("name", ["host", "device"])
def test_tiled_spans_and_counters_match_reference(field, name):
    u, v = field
    was, r_was = obs.enabled(), r_obs.enabled()
    obs.enable()
    r_obs.enable()
    try:
        got, want = {}, {}
        for mod, run, out in (
                (obs, lambda: _port(field, name), got),
                (r_obs, lambda: r_tiling.compress_tiled(
                    u, v, core.CompressionConfig(backend="numpy",
                                                 **CASES[name]),
                    r_tiling.TileGrid(*GRID)), want)):
            s0, c0 = _spans(mod), _tiled_counters(mod)
            run()
            s1, c1 = _spans(mod), _tiled_counters(mod)
            out["spans"] = {k: s1[k] - s0.get(k, 0) for k in s1
                            if s1[k] != s0.get(k, 0)}
            out["counters"] = {k: (tuple(a - b for a, b in zip(c1[k], c0[k]))
                                   if k == "groups" else c1[k] - c0.get(k, 0))
                               for k in c1}
    finally:
        (obs.enable if was else obs.disable)()
        (r_obs.enable if r_was else r_obs.disable)()
    assert got == want
    assert got["spans"]["tiling.compress_tiled"] == 1
    assert got["counters"]["tiling.units_written"] == 32
