"""K5: a 256-bin histogram of each row of uint8 symbols: the symbols
read, 256 int32 counts a row written (the integer adds are not counted:
the card's data sheet gives no scalar integer rate)."""

from . import monolithic_shape

KERNEL = "symbol_histogram_kernel"


def terms(rows: int, n: int):
    return rows * n + rows * 256 * 4, 0


def launches(cfg: dict, n: int, n_calls: int):
    """Every launch of a monolithic cell counts the two components'
    symbols, one a vertex."""
    shape = monolithic_shape(cfg)
    if shape is None:
        return None
    T, H, W = shape
    return [(terms(2, T * H * W), n)]
