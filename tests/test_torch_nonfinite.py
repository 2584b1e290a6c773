"""Non-finite values through the port's MoP path against the JAX package
(CPU).

The fixed point of NaN and +-Inf is INT64_MIN, so its residual's zigzag
fold wraps negative; the MoP histogram must then follow the reference's
scatter-add (a negative key wraps once, a key still out of range is
dropped) instead of failing.  The container must be the reference's
bytes with either codec, cross-decode bitwise, and give the non-finite
value back bit for bit.
"""
import pytest

pytest.importorskip("torch")

import numpy as np

import repro.core as core
import repro_torch
from repro_torch.data import synthetic

BAD = {"nan": np.nan, "+inf": np.inf, "-inf": -np.inf}


def _field(bad):
    # the field of the fault's report: one bad value at flat index 37
    u, v = synthetic.vortex_street(T=4, H=20, W=24)
    u = u.copy()
    u.flat[37] = BAD[bad]
    return u, v


@pytest.mark.parametrize("codec", ["host", "device"])
@pytest.mark.parametrize("bad", list(BAD))
def test_nonfinite_byte_equal_and_bitwise(bad, codec):
    u, v = _field(bad)
    with np.errstate(invalid="ignore"):
        rb, rs = core.compress(u, v, core.CompressionConfig(
            eb=1e-2, mode="abs", backend="numpy", codec=codec))
        pb, ps = repro_torch.compress(u, v, repro_torch.CompressionConfig(
            eb=1e-2, mode="abs", codec=codec), device="cpu")
    assert pb == rb
    assert ps["verify_bad_counts"] == rs["verify_bad_counts"]
    ref_of_port = core.decompress(pb)
    port_of_ref = repro_torch.decompress(rb, device="cpu")
    for a, b, orig in zip(ref_of_port, port_of_ref, (u, v)):
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
        assert np.array_equal(a.view(np.uint32), orig.view(np.uint32))


@pytest.mark.parametrize("bad", list(BAD))
def test_tiled_track_index_raises_like_the_reference(bad):
    """A fault of the reference, ported as is: with the track index on, a
    non-finite value breaks the index's Lemma-1 check.  Both packages
    raise the same Lemma1ViolationError with the same message from
    compress_tiled (9x21x27 field, the bad value at flat index 300; two
    windows of one tile, a grid the reference compiles in seconds)."""
    from repro.core import tiling as JT
    from repro.core import trajectory as JTR
    from repro_torch.core import tiling as TT
    from repro_torch.core import trajectory as TTR

    u, v = synthetic.vortex_street(T=9, H=21, W=27)
    u = u.copy()
    u.flat[300] = BAD[bad]
    with np.errstate(invalid="ignore"):
        with pytest.raises(JTR.Lemma1ViolationError) as ref:
            core.compress_tiled(u, v, core.CompressionConfig(
                eb=1e-2, mode="abs", backend="numpy"),
                JT.TileGrid(21, 27, 5))
        with pytest.raises(TTR.Lemma1ViolationError) as got:
            repro_torch.compress_tiled(
                u, v, repro_torch.CompressionConfig(eb=1e-2, mode="abs"),
                TT.TileGrid(21, 27, 5), device="cpu")
    assert str(got.value) == str(ref.value)
    assert "crossed-face count not in {0, 2}" in str(got.value)
