"""The plain face test (bench/reference/faces.py) against hand-built
cases: a stationary critical point crosses one slice face a frame, two
internal faces a slab and no side face; a point that moves across a
spatial edge crosses side faces; an exact rational point-in-triangle
test agrees on every face of a random field; and a tie resolves by the
symbolic perturbation."""
from fractions import Fraction

import numpy as np
import pytest
import tiny  # noqa: F401
import torch

from bench.reference import faces, judge


def point_field(T, H, W, path):
    """u = x - x0(t), v = y - y0(t) in fixed point (x across W, y along
    H, one unit a grid step, 2^10 fixed-point steps a unit)."""
    y, x = torch.meshgrid(torch.arange(H, dtype=torch.float64),
                          torch.arange(W, dtype=torch.float64),
                          indexing="ij")
    u = torch.stack([x - path(t)[0] for t in range(T)])
    v = torch.stack([y - path(t)[1] for t in range(T)])
    return faces.to_fixed(u, 1024.0), faces.to_fixed(v, 1024.0)


def test_stationary_point_one_crossing_per_face_kind():
    T = 4
    u, v = point_field(T, 5, 6, lambda t: (2.3, 1.6))
    counts = faces.crossing_counts(u, v)
    # the slice triangle that holds the point, every frame; in each slab
    # the two internal faces of that triangle's prism; no side face
    assert counts == {"slice": T, "side": 0, "internal": 2 * (T - 1)}


def test_moving_point_crosses_side_faces():
    T = 3
    u, v = point_field(T, 5, 6, lambda t: (1.3 + 0.9 * t, 1.6))
    counts = faces.crossing_counts(u, v)
    assert counts["slice"] == T
    assert counts["side"] > 0


def _exact_inside(a, b, c):
    """Origin strictly inside triangle abc by exact barycentrics."""
    (ax, ay), (bx, by), (cx, cy) = [(Fraction(int(p[0])), Fraction(int(p[1])))
                                    for p in (a, b, c)]
    d = (bx - ax) * (cy - ay) - (cx - ax) * (by - ay)
    l1 = ((-ax) * (cy - ay) - (cx - ax) * (-ay)) / d
    l2 = ((bx - ax) * (-ay) - (-ax) * (by - ay)) / d
    return l1 > 0 and l2 > 0 and 1 - l1 - l2 > 0


def test_random_field_agrees_with_exact_rational_test():
    g = torch.Generator().manual_seed(5)
    T, H, W = 3, 4, 5
    u = torch.randint(-40, 41, (T, H, W), generator=g)
    v = torch.randint(-40, 41, (T, H, W), generator=g)
    tabs = faces.face_tables(H, W, "cpu")
    uf, vf = u.reshape(-1), v.reshape(-1)
    checked = 0
    for kind, t, crossed in faces.iter_predicates(u, v):
        offset = t * H * W
        for n in range(crossed.shape[0]):
            for f, ids in enumerate(tabs[kind] + (offset + n * H * W)):
                pts = [(uf[i], vf[i]) for i in ids.tolist()]
                dets = [int(p[0] * q[1] - p[1] * q[0]) for p, q in
                        zip(pts, pts[1:] + pts[:1])]
                if 0 in dets:
                    continue
                assert bool(crossed[n, f]) == _exact_inside(*pts), \
                    (kind, n, f)
                checked += 1
    assert checked > 200


@pytest.mark.parametrize("c,expect", [((0, -1), True), ((0, 1), False)])
def test_tie_resolved_by_symbolic_perturbation(c, expect):
    # A = (1, 0), B = (-1, 0): det(A, B) = 0, the origin on edge AB; with
    # index(A) < index(B) the tie takes -sign(B_u) = +1, so the face is
    # crossed exactly when det(B, C) and det(C, A) are positive
    u = torch.tensor([1, -1, c[0]])
    v = torch.tensor([0, 0, c[1]])
    ids = torch.tensor([[0, 1, 2]])
    assert bool(faces.crossed(u, v, ids)[0]) == expect


def test_false_cases_count_changed_faces():
    u, v = point_field(3, 5, 6, lambda t: (2.3, 1.6))
    assert faces.false_cases(u, v, u, v) == {"fc_t": 0, "fc_s": 0}
    u2, v2 = point_field(3, 5, 6, lambda t: (3.3, 1.6))
    fc = faces.false_cases(u, v, u2, v2)
    # the crossed slice triangle moved: two faces a frame changed
    assert fc["fc_t"] == 2 * 3 and fc["fc_s"] > 0


def test_plane_counts_and_sizes_follow_the_format():
    T = 4
    u, v = point_field(T, 5, 6, lambda t: (2.3, 1.6))
    fc = faces.false_cases(u, v, u, v, planes=True)
    assert fc["slice_per_frame"] == [1] * T
    assert fc["slab_per_slab"] == [2] * (T - 1)
    tabs = faces.face_tables(5, 6, "cpu")
    assert faces.plane_sizes(5, 6) == (
        len(tabs["slice"]), len(tabs["side"]) + len(tabs["internal"]))
    # the container format's face numbering (the port's own sizes)
    from repro_torch.core import grid

    for H, W in ((5, 6), (450, 150), (512, 512)):
        assert faces.plane_sizes(H, W) == grid.face_family_sizes(H, W)


def test_judge_reads_the_bound_and_the_shape():
    rng = np.random.default_rng(0)
    u = rng.normal(size=(3, 6, 7)).astype(np.float32)
    v = rng.normal(size=(3, 6, 7)).astype(np.float32)
    eb = judge.eb_abs(u, v, 0.01, "rel")
    ok = judge.judge(u, v, u, v, 0.01, "rel", "cpu")
    assert ok == {"shape_ok": True, "max_err_over_eb": 0.0, "fc_t": 0,
                  "fc_s": 0}
    off = u.copy()
    off[1, 2, 3] += np.float32(2 * eb)
    assert judge.judge(u, v, off, v, 0.01, "rel", "cpu")[
        "max_err_over_eb"] > 1.9
    assert not judge.judge(u, v, u[:2], v[:2], 0.01, "rel", "cpu")[
        "shape_ok"]
