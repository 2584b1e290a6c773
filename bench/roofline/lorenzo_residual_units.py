"""K1 over a stack of units: ufp, vfp, k, lossless read and X written
over each unit's halo extension; the residuals written over each owned
box."""

KERNEL = "lorenzo_residual_units_kernel"


def terms(ext_numel: int, owned_numel: int):
    return ext_numel * (16 + 4 + 1 + 16) + owned_numel * 16, 0


def launches(cfg: dict, n: int, n_calls: int):
    """None: the launches' shapes (the unit chunks' or the geometry
    groups') are not in the profile."""
    return None
