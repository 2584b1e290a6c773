"""K2, one verify round over a (T, H, W) field.  The first round
(screen) reads the four int64 vertex planes (reconstruction and
original); a later round reads the newly forced mask (one byte a
vertex).  Both read the two face tables (int64 triples) once, one
original-predicate byte of each selected face and write three forced
bytes a bad face; ``n_selected`` and ``n_bad`` depend on the data and
count 0 unless given."""

from . import faces_per_plane, monolithic_shape

KERNEL = "verify_faces_kernel"


def terms(T: int, H: int, W: int, screen: bool = True,
          n_selected: int = 0, n_bad: int = 0):
    numel = T * H * W
    fs, fb = faces_per_plane(H, W)
    fields = numel * 32 if screen else numel
    return fields + (fs + fb) * 3 * 8 + n_selected + 3 * n_bad, 0


def launches(cfg: dict, n: int, n_calls: int):
    """A monolithic cell's first launch in each compress is the screen,
    the later ones a round's forced mask."""
    shape = monolithic_shape(cfg)
    if shape is None:
        return None
    screens = min(n, n_calls)
    return [(terms(*shape, True), screens),
            (terms(*shape, False), n - screens)]
