"""K3 over a stack of B units of (T, H, W): K3's terms a unit."""

KERNEL = "sl_decode_units_kernel"


def terms(B: int, T: int, H: int, W: int, block: int):
    nb = T * -(-H // block) * -(-W // block)
    return B * (T * H * W * 32 + nb + T), 0


def launches(cfg: dict, n: int, n_calls: int):
    """None: the launches' shapes (the unit chunks' or the geometry
    groups') are not in the profile."""
    return None
