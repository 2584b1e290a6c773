"""K1: dual-quantize and block Lorenzo residuals of u and v in one
launch over a (T, H, W) field: ufp, vfp (int64), k (int32) and the
lossless mask (bool) read; res_u, res_v (int64) written, and with
``want_x`` (the MoP encode) the quantized xu, xv (int64) too."""

from . import monolithic_shape

KERNEL = "lorenzo_residual_kernel"


def terms(numel: int, want_x: bool = True):
    return numel * (16 + 4 + 1 + 16 + (16 if want_x else 0)), 0


def launches(cfg: dict, n: int, n_calls: int):
    """Every launch of a monolithic cell is at the chunk's shape; X is
    written for the MoP predictor."""
    shape = monolithic_shape(cfg)
    if shape is None:
        return None
    T, H, W = shape
    return [(terms(T * H * W, cfg["compressor"]["predictor"] == "mop"), n)]
