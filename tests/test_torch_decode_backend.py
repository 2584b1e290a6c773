"""The decode-side ``backend=`` of the port (CPU), against the JAX
package's: ``decompress``, ``decompress_tiled``, ``decompress_region``,
``decode_for_track`` and ``extract`` take it in the reference's parameter
order (``device`` keyword-only after it).  Each of "numpy", "xla" and
"pallas" decodes an "xla" and a "pallas" container to the reference's
decode with the same argument, and at least two of them give different
values on each container (the checks are not vacuous); a legacy
container gives the same values under every backend.

Monolithic: the golden containers of tests/test_torch_sl_containers.py
("pallas" at H = 32, "xla" at H = 30), against the reference's decode
with each backend stored beside them
(``tests/data/golden_sl_<tag>_decode_<backend>.npz``, which chip_smoke.py
holds the card to); a test regenerates those decodes with the reference.
Tiled: the 9x24x27 field of test_torch_sl_containers's tiled case, with
the track index, written by the port (whose bytes are the reference's)
and decoded by both packages.

    PYTHONPATH=src python tests/test_torch_decode_backend.py

rewrites the stored decodes.
"""
import pytest

pytest.importorskip("torch")

import inspect

import numpy as np
import torch

import repro.analysis as r_analysis
import repro.core as core
from repro.analysis import query as r_query
from repro.core import tiling as JT
from repro.data import synthetic
import repro_torch
from repro_torch import analysis
from repro_torch.core import compressor, fixedpoint

import test_torch_legacy as L
import test_torch_sl_containers as SL

BACKENDS = ("numpy", "xla", "pallas")


def stored_path(tag, backend):
    return SL.DATA / f"golden_sl_{tag}_decode_{backend}.npz"


def reference_decodes(tag):
    blob = SL.golden_paths(tag)[0].read_bytes()
    return {be: core.decompress(blob, backend=be) for be in BACKENDS}


def write_stored():
    for tag in SL.GOLDEN:
        for be, (ur, vr) in reference_decodes(tag).items():
            np.savez_compressed(stored_path(tag, be), ur=ur, vr=vr)


def _stored(tag, backend):
    d = np.load(stored_path(tag, backend))
    return d["ur"], d["vr"]


def _distinct(decodes):
    """The number of different decodes among ``decodes``."""
    out = []
    for d in decodes:
        if not any(SL._same(d, e) for e in out):
            out.append(d)
    return len(out)


def test_signatures_follow_the_reference():
    from repro.analysis import extraction as r_extraction
    from repro_torch.analysis import extraction
    from repro_torch.core import tiling

    pairs = [(repro_torch.decompress, core.decompress),
             (tiling.decompress_tiled, JT.decompress_tiled),
             (tiling.decompress_region, JT.decompress_region),
             (analysis.decode_for_track, r_analysis.decode_for_track),
             (extraction.extract, r_extraction.extract)]
    for port, ref in pairs:
        got = inspect.signature(port).parameters
        want = list(inspect.signature(ref).parameters)
        positional = [n for n, p in got.items()
                      if p.kind is not p.KEYWORD_ONLY]
        assert positional == want, port.__name__
        assert got["backend"].default is None
        assert got["device"].kind is inspect.Parameter.KEYWORD_ONLY


@pytest.mark.parametrize("tag", list(SL.GOLDEN))
def test_stored_decodes_are_the_references(tag):
    for be, dec in reference_decodes(tag).items():
        assert SL._same(_stored(tag, be), dec), be


@pytest.mark.parametrize("tag", list(SL.GOLDEN))
def test_monolithic_backend_decodes(tag):
    blob = SL.golden_paths(tag)[0].read_bytes()
    got = {be: repro_torch.decompress(blob, be, device="cpu")
           for be in BACKENDS}
    for be in BACKENDS:
        assert SL._same(got[be], _stored(tag, be)), be
    # None replays the header's tag
    assert SL._same(repro_torch.decompress(blob, device="cpu"), got[tag])
    assert _distinct(got.values()) >= 2


def test_legacy_container_ignores_backend():
    blob = L.golden_paths("sl")[0].read_bytes()
    want = core.decompress(blob)
    for be in (None,) + BACKENDS:
        assert SL._same(core.decompress(blob, backend=be), want), be
        assert SL._same(repro_torch.decompress(blob, be, device="cpu"),
                        want), be


def test_backend_names_checked():
    blob = SL.golden_paths("xla")[0].read_bytes()
    with pytest.raises(ValueError, match="unknown backend"):
        repro_torch.decompress(blob, "bogus", device="cpu")
    # "numpy" asks for the plain versions, which run on the CPU only
    with pytest.raises(ValueError, match='device="cpu"'):
        compressor.refuse_plain_on_card("numpy", torch.device("cuda"))
    for be in (None, "xla", "pallas"):
        compressor.refuse_plain_on_card(be, torch.device("cuda"))


# ----------------------------------------------------------------------
# tiled containers, region reads, track queries, extraction
# ----------------------------------------------------------------------

def _tiled_field():
    shape = (9, 24, 27)
    u, v = synthetic.vortex_street(T=9, H=24, W=27)
    rng = np.random.default_rng(0)
    return tuple((np.asarray(a) + rng.standard_normal(shape))
                 .astype(np.float32) for a in (u, v))


@pytest.fixture(scope="module")
def tiled():
    """{tag: (container, stats)} of the port, one tile and two windows,
    with the track index."""
    u, v = _tiled_field()
    return {tag: repro_torch.compress_tiled(
        u, v, repro_torch.CompressionConfig(
            eb=1e-2, dt=20.0, n_max=8, backend=tag),
        repro_torch.TileGrid(24, 27, 5), device="cpu")
        for tag in ("xla", "pallas")}


def _ref(fn, *args, **kw):
    # the reference's decoded-unit cache is keyed without the backend
    # (ROADMAP Queue 3 item 19): each of its reads starts cold, so it
    # decodes with the one asked for
    r_query.unit_cache.clear()
    return fn(*args, **kw)


def _same_track(a, b):
    return (np.array_equal(a.face_ids, b.face_ids)
            and np.array_equal(a.nodes, b.nodes)
            and np.array_equal(a.types, b.types) and a.is_loop == b.is_loop)


@pytest.mark.parametrize("tag", ["xla", "pallas"])
def test_tiled_backend_decodes(tiled, tag):
    """Full, region and track reads with each backend == the
    reference's.  The port's reads run back to back through its
    decoded-unit cache, which keys a unit's decode by its stepper."""
    blob, _ = tiled[tag]
    region = (2, 8, 3, 20, 0, 27)
    tracks = analysis.track_summaries(blob)
    k = max(tracks, key=lambda s: s["n_nodes"])["track_id"]
    full = {}
    for be in BACKENDS:
        full[be] = repro_torch.decompress_tiled(blob, None, be, device="cpu")
        assert SL._same(full[be], _ref(JT.decompress_tiled, blob,
                                       backend=be)), be
        assert SL._same(full[be], repro_torch.decompress(blob, be,
                                                         device="cpu"))
        got = repro_torch.decompress_region(blob, region, be, device="cpu")
        assert SL._same(got, _ref(JT.decompress_region, blob, region,
                                  backend=be)), be
        res = analysis.decode_for_track(blob, k, be, device="cpu")
        ref = _ref(r_analysis.decode_for_track, blob, k, backend=be)
        assert _same_track(res.track, ref.track), be
    assert _distinct(full.values()) >= 2


def test_extract_takes_backend(tiled):
    blob, st = tiled["xla"]
    ur, vr = repro_torch.decompress_tiled(blob, device="cpu")
    ufp, vfp = fixedpoint.refix(ur, vr, st["scale"])
    want = analysis.extract(ufp, vfp, device="cpu")
    ref = r_analysis.extract(ufp, vfp, "numpy")
    for be in BACKENDS:
        got = analysis.extract(ufp, vfp, be, device="cpu")
        assert got.n_tracks == want.n_tracks == ref.n_tracks
        for k in range(got.n_tracks):
            assert _same_track(got.track(k), want.track(k))
            assert _same_track(got.track(k), ref.track(k))
    with pytest.raises(ValueError, match="unknown backend"):
        analysis.extract(ufp, vfp, "bogus", device="cpu")


if __name__ == "__main__":
    write_stored()
