"""K2 over a stack of unit extensions (screen): each extension's four
int64 planes, and the face tables of the extension's plane once."""

from . import faces_per_plane

KERNEL = "verify_faces_units_kernel"


def terms(B: int, T: int, H: int, W: int, n_selected: int = 0,
          n_bad: int = 0):
    fs, fb = faces_per_plane(H, W)
    return (B * T * H * W * 32 + (fs + fb) * 3 * 8 + n_selected
            + 3 * n_bad), 0


def launches(cfg: dict, n: int, n_calls: int):
    """None: the launches' shapes (the unit chunks' or the geometry
    groups') are not in the profile."""
    return None
