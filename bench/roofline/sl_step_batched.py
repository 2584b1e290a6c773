"""K4: the encoder's SL predictions of frames 1..T-1 from frames
0..T-2, one launch over the (T-1, H, W) stack: 16 bytes a pixel in, 16
out.  The f64 operations depend on the data and are not counted."""

from . import monolithic_shape

KERNEL = "sl_step_batched_kernel"


def terms(n_frames: int, H: int, W: int):
    return n_frames * H * W * 32, 0


def launches(cfg: dict, n: int, n_calls: int):
    """Every launch of a monolithic cell steps the chunk's T - 1 frames."""
    shape = monolithic_shape(cfg)
    if shape is None:
        return None
    T, H, W = shape
    return [(terms(T - 1, H, W), n)]
