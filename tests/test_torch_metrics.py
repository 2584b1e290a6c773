"""The port's evaluation metrics against the JAX package (CPU).

``metrics.evaluate`` with its default arguments (``with_tracks=True``)
gives the reference's dict, the track counts ``n_traj_orig`` /
``n_traj_rec`` included; ``trajectory.extract_tracks`` gives the
reference's counts; and the entry points run on CUDA unless the caller
passes ``device="cpu"``.
"""
import pytest

pytest.importorskip("torch")

import numpy as np
import torch

from repro.core import fixedpoint as r_fixedpoint, metrics as r_metrics, \
    trajectory as r_trajectory
import repro_torch
from repro_torch.core import metrics, trajectory
from repro_torch.data import synthetic


def _cumsum_field(shape, seed=3):
    rng = np.random.default_rng(seed)
    base = np.cumsum(rng.normal(size=shape).astype(np.float32), axis=0)
    return base, base[::-1].copy()


FIELDS = {
    "cumsum": lambda: _cumsum_field((4, 24, 24)),
    "gyre": lambda: synthetic.double_gyre(T=6, H=20, W=28),
    "vortex": lambda: synthetic.vortex_street(T=5, H=16, W=24),
    "tiny": lambda: _cumsum_field((2, 5, 7), seed=5),
}


@pytest.mark.parametrize("name", list(FIELDS))
def test_extract_tracks_equals_reference(name):
    u, v = FIELDS[name]()
    _, ufp, vfp = r_fixedpoint.to_fixed(u, v)
    want = r_trajectory.extract_tracks(ufp, vfp)
    tables = trajectory.face_predicate_tables(ufp, vfp, device="cpu")
    assert trajectory.extract_tracks(ufp, vfp, device="cpu") == want
    assert trajectory.extract_tracks(ufp, vfp, tables=tables,
                                     device="cpu") == want
    assert want["n_tracks"] > 0


@pytest.mark.parametrize("name", ["cumsum", "gyre"])
@pytest.mark.parametrize("rec", ["compressed", "perturbed"])
def test_evaluate_defaults_equal_reference(name, rec):
    u, v = FIELDS[name]()
    blob, st = repro_torch.compress(u, v, repro_torch.CompressionConfig(),
                                    device="cpu")
    if rec == "compressed":
        ur, vr = repro_torch.decompress(blob, device="cpu")
    else:
        rng = np.random.default_rng(1)
        ur = u + 0.05 * rng.normal(size=u.shape).astype(np.float32)
        vr = v + 0.05 * rng.normal(size=v.shape).astype(np.float32)
    args = (u, v, ur, vr, st["scale"], st["orig_bytes"], st["comp_bytes"])
    want = r_metrics.evaluate(*args)
    got = metrics.evaluate(*args, device="cpu")
    assert got == want
    assert {"n_traj_orig", "n_traj_rec"} <= set(got)
    if rec == "compressed":
        assert got["FC_t"] == got["FC_s"] == 0
        assert got["n_traj_orig"] == got["n_traj_rec"]
    else:
        assert got["FC_t"] + got["FC_s"] > 0
    assert metrics.evaluate(*args, with_tracks=False, device="cpu") \
        == r_metrics.evaluate(*args, with_tracks=False)


def test_entry_points_default_to_cuda(monkeypatch):
    u, v = FIELDS["tiny"]()
    scale, ufp, vfp = r_fixedpoint.to_fixed(u, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: trajectory.false_cases(u, v, u, v, scale),
        lambda: trajectory.face_predicate_tables(ufp, vfp),
        lambda: trajectory.extract_tracks(ufp, vfp),
        lambda: metrics.evaluate(u, v, u, v, scale, 10, 1),
        lambda: metrics.evaluate(u, v, u, v, scale, 10, 1,
                                 with_tracks=False),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert trajectory.false_cases(u, v, u, v, scale,
                                  device="cpu")["FC_t"] == 0
