"""The kernels' compulsory bytes reproduce the byte counts of PERF.md's
kernel table (SCF analogue (120, 100, 225); unit rows at the tiled
64 x 512 x 512 run's largest launch)."""
import tiny  # noqa: F401
import pytest

from bench import roofline

SCF = (120, 100, 225)
CASES = [
    # (kernel, args, MB in the table, decimals)
    ("lorenzo_residual_kernel", (120 * 100 * 225, True), 143.1, 1),
    ("lorenzo_residual_units_kernel",
     (4 * 33 * 130 * 130, 4 * 32 * 128 * 128), 116.1, 1),
    ("verify_faces_units_kernel", (4, 33, 130, 130), 76.2, 1),
    ("sl_decode_kernel", SCF + (16,), 86.4, 1),
    ("sl_decode_units_kernel", (4, 32, 128, 128, 16), 67.1, 1),
    ("sl_step_batched_kernel", (119, 100, 225), 85.7, 1),
    ("symbol_histogram_kernel", (2, 2_700_000), 5.40, 2),
    ("face_crossed_kernel", (50_331_648, 4 * 33 * 129 * 129), 1290.0, -1),
]


@pytest.mark.parametrize("kernel,args,mb,nd", CASES,
                         ids=[c[0] for c in CASES])
def test_bytes_match_the_table(kernel, args, mb, nd):
    nbytes, ops = roofline.kernels()[kernel].terms(*args)
    assert round(nbytes / 1e6, nd) == mb
    assert ops == 0


def test_verify_faces_screen_is_the_tables_lower_bound():
    # 92.9 MB in the table: the screen's fields and tables (92.8 MB)
    # plus the selected faces' bytes, which depend on the data
    nbytes, _ = roofline.kernels()["verify_faces_kernel"].terms(*SCF)
    assert 92.7e6 < nbytes <= 92.9e6
    later, _ = roofline.kernels()["verify_faces_kernel"].terms(
        *SCF, screen=False)
    assert later < nbytes


def test_faces_per_plane_counts_the_mesh():
    fs, fb = roofline.faces_per_plane(3, 4)
    # 6 cells: 12 triangles; 3*3 + 2*4 + 6 = 23 edges
    assert (fs, fb) == (12, 2 * 23 + 4 * 6)


def test_bound_is_the_larger_term():
    assert roofline.bound_s(3.35e12) == pytest.approx(1.0)
    assert roofline.bound_s(0, 34e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e12, 68e12) == pytest.approx(2.0)


MONO = {"chunk_frames": 6, "field": {"H": 24, "W": 40}, "tiling": None,
        "compressor": {"predictor": "mop", "block": 16}}
TILED = dict(MONO, tiling={"tile_h": 16, "tile_w": 12, "window_t": 4})


@pytest.mark.parametrize("kernel", sorted(roofline.kernels()))
def test_every_kernel_maps_its_launches(kernel):
    mod = roofline.kernels()[kernel]
    # a tiled cell's launches are at unit shapes the profile lacks
    assert mod.launches(TILED, 5, 2) is None
    got = mod.launches(MONO, 5, 2)
    if kernel.endswith("_units_kernel") or kernel == "face_crossed_kernel":
        assert got is None
        return
    assert sum(k for _, k in got) == 5
    assert all(t[0] > 0 for t, _ in got)


def test_verify_faces_launches_screen_once_a_call():
    mod = roofline.kernels()["verify_faces_kernel"]
    (screen, n1), (later, n2) = mod.launches(MONO, 5, 2)
    assert (n1, n2) == (2, 3)
    assert screen == mod.terms(6, 24, 40, True)
    assert later == mod.terms(6, 24, 40, False)
