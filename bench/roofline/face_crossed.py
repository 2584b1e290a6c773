"""K2's face predicate (the track index): each face's three int64 vertex
ids read and its crossed byte written; the u and v values (int64) of
the distinct vertices the faces name read once."""

KERNEL = "face_crossed_kernel"


def terms(n_faces: int, n_verts: int):
    return n_faces * 3 * 8 + n_faces + n_verts * 16, 0


def launches(cfg: dict, n: int, n_calls: int):
    """None: the launches' shapes (the unit chunks' or the geometry
    groups') are not in the profile."""
    return None
