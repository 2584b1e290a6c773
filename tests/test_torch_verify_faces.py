"""The verify round's face check on the CPU: ``verify_faces``.

``cptest.ops.verify_faces`` (the plain version the CPU dispatch runs)
must do what the JAX package's ``pipeline.check_faces`` does, exactly:
the same faces forced (``forced`` after the call == ``forced | add``)
and the same bad-face count, in the screen mode (first round) and the
incremental mode (faces touched by ``delta``), with the original
predicates from the reference's ``ebound.derive_vertex_eb``.  Inputs
sit near zero with ties and collinear pairs, reconstructions are the
originals moved by 0, 1 or 2; T = 1 has no slab faces.  The kernel's
walk over the faces (a CTA a run of frames and a block of rows and
columns) is transcribed here from csrc/cptest.cu and must cover every
face once, at every width.
The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""
import pytest

pytest.importorskip("torch")

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

import repro.core as core
from repro.core import ebound as r_ebound
from repro.core import pipeline as r_pipeline
import repro_torch
from repro_torch.core import grid
from repro_torch.kernels.cptest import ops as cp_ops

SHAPES = [(4, 16, 16), (5, 9, 13), (3, 7, 5), (1, 8, 8)]
DELTAS = ["empty", "full", "random", "border"]
CU = Path(repro_torch.__file__).parent / "csrc" / "cptest.cu"


def _fields(shape, seed):
    """(ufp, vfp, ur_fp, vr_fp) int64: small values (many zeros and
    sign ties), some large ones, collinear neighbour pairs, and
    reconstructions = originals + {-2..2}."""
    rng = np.random.default_rng(seed)
    o = rng.integers(-3, 4, (2,) + shape).astype(np.int64)
    big = rng.random((2,) + shape) < 0.2
    o[big] = rng.integers(-(2 ** 20), 2 ** 20, int(big.sum()))
    flat = o.reshape(2, -1)
    n = flat.shape[1]
    src = rng.choice(n, max(1, n // 8), replace=False)
    dst = np.minimum(src + 1, n - 1)
    k = rng.integers(-2, 3, len(src))
    flat[:, dst] = flat[:, src] * k                # collinear with a neighbour
    r = o + rng.integers(-2, 3, o.shape)
    same = rng.random(o.shape) < 0.4                 # unchanged vertices
    r[same] = o[same]
    return o[0], o[1], r[0], r[1]


def _delta(kind, shape, seed):
    T, H, W = shape
    if kind == "empty":
        return np.zeros(shape, dtype=bool)
    if kind == "full":
        return np.ones(shape, dtype=bool)
    if kind == "random":
        return np.random.default_rng(seed).random(shape) < 0.05
    d = np.zeros(shape, dtype=bool)
    d[:, 0, :] = d[:, -1, :] = d[:, :, 0] = d[:, :, -1] = True
    return d


def _reference(shape, ufp, vfp, ur, vr, delta, be):
    """(add mask or None, n_bad) of the JAX package's check_faces and the
    original predicates (slice0, slab0) it used."""
    _, slice0, slab0 = r_ebound.derive_vertex_eb(jnp.asarray(ufp),
                                                 jnp.asarray(vfp), 8)
    preds = (np.array(slice0), np.array(slab0))
    fns = r_pipeline.UnitFns(shape, 16, 1, "mop", be)
    add, n = r_pipeline.check_faces(fns, shape, jnp.asarray(ufp),
                                    jnp.asarray(vfp), jnp.asarray(ur),
                                    jnp.asarray(vr), preds, delta)
    return add, n, preds


def _port(shape, ufp, vfp, ur, vr, delta, preds, forced0):
    T, H, W = shape
    tabs = grid.device_tables(H, W, "cpu")
    forced = torch.as_tensor(forced0.copy())
    n = cp_ops.verify_faces(
        torch.as_tensor(ur), torch.as_tensor(vr), torch.as_tensor(ufp),
        torch.as_tensor(vfp),
        None if delta is None else torch.as_tensor(delta),
        tabs["slice"], tabs["slab"], torch.as_tensor(preds[0]),
        torch.as_tensor(preds[1]), forced)
    assert n.dtype == torch.int64 and n.ndim == 0
    return forced.numpy(), int(n)


@pytest.mark.parametrize("be", ["numpy", "pallas"])
@pytest.mark.parametrize("mode", ["screen"] + DELTAS)
@pytest.mark.parametrize("shape", SHAPES)
def test_verify_faces_plain_equals_check_faces(shape, mode, be):
    seed = sum(shape) + len(mode)
    ufp, vfp, ur, vr = _fields(shape, seed)
    delta = None if mode == "screen" else _delta(mode, shape, seed)
    add, n_ref, preds = _reference(shape, ufp, vfp, ur, vr, delta, be)
    forced0 = np.random.default_rng(seed + 1).random(shape) < 0.1
    forced, n = _port(shape, ufp, vfp, ur, vr, delta, preds, forced0)
    want = forced0 if add is None else forced0 | add
    assert n == n_ref
    assert np.array_equal(forced, want)
    if mode in ("screen", "full"):
        assert n_ref > 0, "the fixture should flip some faces"
    if mode == "empty":
        assert n == 0 and np.array_equal(forced, forced0)


@pytest.mark.parametrize("shape", SHAPES)
def test_verify_faces_all_selected_and_none_selected(shape):
    """An all-zero original leaves no face to the screen; a field of one
    strict sign in both fields clears every face (count 0, forced
    untouched)."""
    T, H, W = shape
    zero = np.zeros(shape, np.int64)
    _, _, ur, vr = _fields(shape, 5)
    add, n_ref, preds = _reference(shape, zero, zero, ur, vr, None, "numpy")
    forced0 = np.zeros(shape, dtype=bool)
    forced, n = _port(shape, zero, zero, ur, vr, None, preds, forced0)
    assert n == n_ref and n > 0
    assert np.array_equal(forced, add)

    pos = np.full(shape, 7, np.int64)
    _, _, preds = _reference(shape, pos, pos, pos, pos, None, "numpy")
    forced0 = np.random.default_rng(1).random(shape) < 0.3
    forced, n = _port(shape, pos, pos, pos + 1, pos + 2, None, preds,
                      forced0)
    assert n == 0 and np.array_equal(forced, forced0)


def _kernel_const(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", CU.read_text())
    assert m, f"{name} not found in cptest.cu"
    return int(m.group(1))


def _walk(shape, records, start, fs, rows, cols):
    """Transcription of verify_faces_kernel's walk for one block shape:
    CTA b -> (column block b mod n_blocks, band of ``rows`` rows, run of
    kFrames frames) -> the records of the faces whose first vertex lies in
    the block (a range of ``start`` a row) -> the run's frames (T, or T-1
    for slab faces).  Each vertex a face tests must map (staged_at) to a
    staged byte that holds that very vertex of that frame.  Returns the
    visits of each (frame, slice face) and (frame, slab face)."""
    T, H, W = shape
    hw = H * W
    kf = _kernel_const("kFrames")
    n_blocks = (W + cols - 1) // cols
    n_bands = (H + rows - 1) // rows
    runs = (T + kf - 1) // kf
    pitch, plane = cols + 1, (rows + 1) * (cols + 1)
    seen_sl = np.zeros((T, fs), np.int64)
    seen_sb = np.zeros((max(T - 1, 0), len(records) - fs), np.int64)
    for b in range(runs * n_bands * n_blocks):
        i0 = b // n_blocks % n_bands * rows
        j0 = b % n_blocks * cols
        t0 = b // n_blocks // n_bands * kf
        st_rows, st_cols = min(rows + 1, H - i0), min(cols + 1, W - j0)
        n_planes = min(kf + 1, T - t0)
        j1 = min(j0 + cols, W)
        for r in range(min(rows, H - i0)):
            row0 = (i0 + r) * W
            mine = records[start[row0 + j0]:start[row0 + j1]]
            ids = mine[:, 1:]
            up = (ids >= hw).astype(np.int64)
            pos = ids - up * hw
            down = (pos >= row0 + W).astype(np.int64)
            at = (up * plane + (r + down) * pitch + pos - row0 - down * W
                  - j0)
            slab = mine[:, 0] >= fs
            for t in range(t0, t0 + kf):
                on = np.where(slab, t < T - 1, t < T)
                if not on.any():
                    continue
                idx = at[on] + (t - t0) * plane
                p, rem = np.divmod(idx, plane)
                rr, cc = np.divmod(rem, pitch)
                assert ((p < n_planes) & (rr < st_rows) & (cc < st_cols)
                        & (idx >= 0)).all()
                staged_vertex = (t0 + p) * hw + (i0 + rr) * W + j0 + cc
                assert np.array_equal(staged_vertex, ids[on] + t * hw)
                f = mine[on, 0]
                sl = f < fs
                np.add.at(seen_sl, (np.full(sl.sum(), t), f[sl]), 1)
                np.add.at(seen_sb, (np.full((~sl).sum(), t), f[~sl] - fs), 1)
    return seen_sl, seen_sb


@pytest.mark.parametrize("shape", SHAPES + [(120, 7, 9), (9, 3, 4),
                                            (2, 2, 2), (17, 1, 6),
                                            (2, 3, 2500)])
def test_verify_faces_kernel_walk_covers_every_face_once(shape):
    """The kernel's walk (``_walk``) for every band height the launch may
    pick, with the column blocks the launch picks for W (one block up to
    kMaxCols columns, else W split evenly into blocks of at most that) and
    with narrow blocks of 3 and 1 columns: every (frame, face) of both
    families is visited exactly once, from staged bytes of its own
    vertices.  ``grid.face_walk`` lists every face once with its own
    table row's ids, sorted by the first vertex, with the first record of
    each plane position."""
    T, H, W = shape
    hw = H * W
    records, start = grid.face_walk(H, W, "cpu")
    assert records.dtype == start.dtype == torch.int32
    assert grid.face_walk(H, W, "cpu")[0] is records
    rec = records.numpy().astype(np.int64)
    starts = start.numpy().astype(np.int64)
    tabs = grid.device_tables(H, W, "cpu")
    fs, fb = len(tabs["slice"]), len(tabs["slab"])
    tab = np.concatenate([tabs["slice"].numpy(), tabs["slab"].numpy()])
    assert np.array_equal(np.sort(rec[:, 0]), np.arange(fs + fb))
    assert np.array_equal(rec[:, 1:], tab[rec[:, 0]])
    first = (rec[:, 1:] % hw).min(axis=1)
    assert (np.diff(first) >= 0).all()
    assert len(starts) == hw + 1
    assert np.array_equal(starts, np.searchsorted(first, np.arange(hw + 1)))
    rows_max = _kernel_const("kMaxRows")
    cols_max = _kernel_const("kMaxCols")
    n_blocks = (W + cols_max - 1) // cols_max
    picked = (W + n_blocks - 1) // n_blocks
    for rows in sorted({min(r, H) for r in (rows_max, 2, 1)}):
        for cols in sorted({picked, min(3, W), 1}):
            seen_sl, seen_sb = _walk(shape, rec, starts, fs, rows,
                                     cols)
            assert (seen_sl == 1).all() and (seen_sb == 1).all(), \
                (rows, cols)


def test_compress_verify_fixture_bad_counts():
    """The verify-firing fixture (the only CPU case that reaches the
    incremental mode): the port's compress reports the reference's
    verify accounting, [506, 0]."""
    rng = np.random.default_rng(3)
    u = (1.0e8 + rng.normal(0, 100.0, (4, 16, 16))).astype(np.float32)
    v = (1.0e8 + rng.normal(0, 100.0, (4, 16, 16))).astype(np.float32)
    kw = dict(eb=6.0, mode="abs", predictor="mop")
    _, rs = core.compress(u, v, core.CompressionConfig(backend="numpy", **kw))
    blob, ps = repro_torch.compress(u, v, repro_torch.CompressionConfig(**kw),
                                    device="cpu")
    assert rs["verify_bad_counts"] == [506, 0]
    assert ps["verify_bad_counts"] == [506, 0]
    assert ps["verify_rounds"] == rs["verify_rounds"] == 1
