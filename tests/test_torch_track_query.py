"""The port's trajectory analytics and track queries against the JAX
package (CPU).

``repro_torch.analysis.extract`` must give the reference's TrajectorySet
(face ids, nodes, types, edges, tracks) bit for bit; on a tiled
container with the track index, ``track_summaries``, ``query_tracks``
and ``track_read_plan`` must equal the reference's, and
``decode_for_track``'s polyline must equal the reference's and the full
extraction's while reading fewer units than the field; a warm query
issues fewer range reads (the decoded-unit cache); and
``track_aware_policy`` must be the reference's policy.  Mirrors
tests/test_analysis_tracks.py and tests/test_track_query.py.
"""
import copy

import numpy as np
import pytest

from repro import analysis as r_analysis
from repro.analysis import query as r_query
import repro.core as core
import repro_torch
from repro_torch import analysis
from repro_torch.analysis import model, query
from repro_torch.core import encode, fixedpoint
from repro_torch.data import synthetic

META = dict(eb=1e-2, mode="rel", dt=0.1, dx=2.0 / 27, dy=1.0 / 19)
GRID = (10, 14, 4)


def _fields():
    return {
        "double_gyre": synthetic.double_gyre(T=6, H=20, W=28),
        "vortex_street": synthetic.vortex_street(T=6, H=24, W=36),
    }


def _same_sets(a, b):
    for k in ("nodes", "face_ids", "types", "track_of", "edges"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert a.shape == b.shape and a.n_tracks == b.n_tracks
    for x, y in zip(a.tracks, b.tracks):
        assert x.track_id == y.track_id and x.is_loop == y.is_loop
        assert np.array_equal(x.nodes, y.nodes)
        assert np.array_equal(x.face_ids, y.face_ids)
        assert np.array_equal(x.types, y.types)


@pytest.mark.parametrize("name", ["double_gyre", "vortex_street"])
def test_extract_equals_reference(name):
    u, v = _fields()[name]
    _, ufp, vfp = fixedpoint.to_fixed(u, v)
    got = analysis.extract(ufp, vfp, device="cpu")
    want = r_analysis.extract(ufp, vfp, backend="numpy")
    _same_sets(got, want)
    assert got.n_tracks > 0 and got.summary() == want.summary()
    bare = analysis.extract(ufp, vfp, device="cpu", classify=False)
    assert (bare.types == model.CP_CODE["degenerate"]).all()


def test_double_gyre_oracle():
    """Two gyre cores (centers) and two boundary saddles, alive for the
    whole window."""
    u, v = _fields()["double_gyre"]
    _, ufp, vfp = fixedpoint.to_fixed(u, v)
    ts = analysis.extract(ufp, vfp, device="cpu")
    assert ts.n_tracks == 4
    kinds = sorted(t.dominant_type for t in ts.tracks)
    assert kinds == ["center", "center", "saddle", "saddle"]
    for t in ts.tracks:
        assert t.events(6) == {"birth": "domain_start",
                               "death": "domain_end"}


def test_order_component_rules():
    # an open path walks from the smaller-keyed end
    keys = np.array([30, 10, 20], np.int64)
    edges = np.array([[0, 2], [2, 1]])
    assert model.order_component(keys, edges).tolist() == [1, 2, 0]
    # a loop starts at the smallest key toward its smaller neighbour
    keys = np.array([5, 9, 7, 8], np.int64)
    edges = np.array([[0, 1], [1, 3], [3, 2], [2, 0]])
    assert model.order_component(keys, edges).tolist() == [0, 2, 3, 1]
    with pytest.raises(ValueError, match="degree"):
        model.order_component(np.arange(4), np.array([[0, 1], [0, 2],
                                                      [0, 3]]))


@pytest.fixture(scope="module")
def indexed():
    """The reference's tiled container with the track index (the port
    writes the same bytes: tests/test_torch_tiling.py)."""
    u, v = synthetic.double_gyre(T=8, H=20, W=28)
    blob, st = core.compress_tiled(
        u, v, core.CompressionConfig(backend="numpy", **META),
        core.TileGrid(*GRID))
    return u, v, blob, st


def test_port_writes_the_indexed_container(indexed):
    u, v, blob, _ = indexed
    got, _ = repro_torch.compress_tiled(
        u, v, repro_torch.CompressionConfig(**META),
        repro_torch.TileGrid(*GRID), device="cpu")
    assert got == blob


def test_summaries_queries_and_plans_equal_reference(indexed):
    _, _, blob, _ = indexed
    summaries = analysis.track_summaries(blob)
    assert summaries == r_analysis.track_summaries(blob)
    assert len(summaries) == 4
    H, W = 20, 28
    for kw in (dict(cp_type="center"), dict(cp_type="saddle"),
               dict(bbox=(5, H - 6, 0, W / 2 - 3), cp_type="center"),
               dict(trange=(0, 1)), dict(trange=(13, 17))):
        assert analysis.query_tracks(blob, **kw) == \
            r_analysis.query_tracks(blob, **kw)
    assert len(analysis.query_tracks(blob, bbox=(5, H - 6, 0, W / 2 - 3),
                                     cp_type="center")) == 1
    with pytest.raises(ValueError, match="unknown cp_type"):
        analysis.query_tracks(blob, cp_type="vortexx")
    n_units = len(encode.tiled_header(blob)["units"])
    for s in summaries:
        plan = analysis.track_read_plan(blob, s["track_id"])
        assert plan == r_analysis.track_read_plan(blob, s["track_id"])
        assert 0 < len(plan) < n_units


def test_decode_for_track_equals_reference_and_full_extraction(indexed):
    _, _, blob, st = indexed
    ur, vr = repro_torch.decompress_tiled(blob, device="cpu")
    ufp, vfp = fixedpoint.refix(ur, vr, st["scale"])
    full = analysis.extract(ufp, vfp, device="cpu")
    assert full.n_tracks == len(analysis.track_summaries(blob))
    for k in range(full.n_tracks):
        res = analysis.decode_for_track(blob, k, device="cpu")
        ref = r_analysis.decode_for_track(blob, k, backend="numpy")
        for want in (full.track(k), ref.track):
            assert np.array_equal(res.track.face_ids, want.face_ids)
            assert np.array_equal(res.track.nodes, want.nodes)   # bitwise
            assert np.array_equal(res.track.types, want.types)
            assert res.track.is_loop == want.is_loop
        assert res.units_read < res.units_total
        assert res.entries == analysis.track_read_plan(blob, k)
        assert res.bytes_read == sum(e["len"] for e in res.entries)
        assert res.complete and res.pieces == ()


def test_path_source_and_warm_cache_issue_fewer_reads(tmp_path, indexed):
    _, _, blob, _ = indexed
    p = tmp_path / "field.cptt"
    p.write_bytes(blob)
    query.unit_cache.clear()
    cold = analysis.decode_for_track(str(p), 0, device="cpu")
    warm = analysis.decode_for_track(str(p), 0, device="cpu")
    assert warm.range_reads < cold.range_reads
    assert warm.bytes_fetched < cold.bytes_fetched
    assert cold.cache_hits == 0 and warm.cache_hits == warm.units_read > 0
    assert warm.entries == cold.entries and warm.bytes_read == cold.bytes_read
    assert np.array_equal(warm.track.nodes, cold.track.nodes)
    # content-addressed: the same container as bytes hits the entries
    from_bytes = analysis.decode_for_track(blob, 0, device="cpu")
    assert from_bytes.cache_hits == from_bytes.units_read
    assert analysis.track_summaries(str(p)) == analysis.track_summaries(blob)


def test_cache_bounded_disablable_and_serves_region_decodes(indexed):
    _, _, blob, _ = indexed
    cache = query.configure_unit_cache(0)
    try:
        a = analysis.decode_for_track(blob, 0, device="cpu")
        b = analysis.decode_for_track(blob, 0, device="cpu")
        assert a.cache_hits == b.cache_hits == 0
        assert cache.stats()["entries"] == 0
        query.configure_unit_cache(0.02)             # ~20 KB
        analysis.decode_for_track(blob, 0, device="cpu")
        s = cache.stats()
        assert 0 < s["bytes"] <= s["max_bytes"]
        query.configure_unit_cache(256)
        region = (0, 2, 0, 8, 0, 8)
        r1 = repro_torch.decompress_region(blob, region, device="cpu")
        s1 = cache.stats()
        r2 = repro_torch.decompress_region(blob, region, device="cpu")
        s2 = cache.stats()
        assert s2["misses"] == s1["misses"] and s2["hits"] > s1["hits"]
        assert np.array_equal(r1[0], r2[0]) and np.array_equal(r1[1], r2[1])
    finally:
        query.configure_unit_cache(256)


def test_cache_size_from_the_environment(monkeypatch):
    monkeypatch.setenv("REPRO_UNIT_CACHE_MB", "3")
    assert query._cache_mb_from_env() == 3.0
    monkeypatch.setenv("REPRO_UNIT_CACHE_MB", "lots")
    with pytest.warns(UserWarning, match="REPRO_UNIT_CACHE_MB"):
        assert query._cache_mb_from_env() == 256.0


def test_no_index_and_future_index_refused(indexed):
    _, _, blob, _ = indexed
    hdr = encode.tiled_header(blob)
    section = copy.deepcopy(hdr[encode.TRACK_INDEX_KEY])
    section["version"] = 99
    with pytest.raises(ValueError, match="track index version 99"):
        analysis.TrackIndex(section)
    stripped = dict(hdr)
    stripped.pop(encode.TRACK_INDEX_KEY)
    with pytest.raises(ValueError, match="no track index"):
        analysis.parse_track_index(stripped)
    idx = analysis.parse_track_index(hdr)
    with pytest.raises(IndexError):
        idx.cover_units(idx.n_tracks)


def test_track_aware_policy_equals_reference():
    u, v = synthetic.double_gyre(T=8, H=20, W=28)
    kw = dict(tight=1e-3, relaxed=2e-2, window_t=4, tile_h=10, tile_w=14)
    got = analysis.track_aware_policy(u, v, device="cpu", **kw)
    want = r_analysis.track_aware_policy(u, v, backend="numpy", **kw)
    assert got.spec() == want.spec()
    assert analysis.track_units(u, v, 4, 10, 14, device="cpu") == \
        r_analysis.track_units(u, v, 4, 10, 14, backend="numpy")
    with pytest.raises(ValueError, match="tight"):
        analysis.track_aware_policy(u, v, tight=1.0, relaxed=0.5,
                                    device="cpu")


def test_reference_cache_untouched_by_the_port(indexed):
    """The two packages keep separate caches: a port query neither
    fills nor reads the reference's."""
    _, _, blob, _ = indexed
    r_query.unit_cache.clear()
    analysis.decode_for_track(blob, 1, device="cpu")
    assert r_query.unit_cache.stats()["entries"] == 0
