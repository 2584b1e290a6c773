"""K3: the SL decode of a (T, H, W) field in one launch: 16 bytes a
pixel read (residuals) and 16 written (xu, xv), plus the blockmap (a
byte a block) and the per-frame flags.  The stepper's f64 operations
depend on the data and are not counted."""

from . import monolithic_shape

KERNEL = "sl_decode_kernel"


def terms(T: int, H: int, W: int, block: int):
    nb = T * -(-H // block) * -(-W // block)
    return T * H * W * 32 + nb + T, 0


def launches(cfg: dict, n: int, n_calls: int):
    """Every launch of a monolithic cell decodes the chunk."""
    shape = monolithic_shape(cfg)
    if shape is None:
        return None
    return [(terms(*shape, cfg["compressor"]["block"]), n)]
