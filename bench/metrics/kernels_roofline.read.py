"""Kernels of a monolithic read: K3 (the SL decode), percent of the
card's roofline (bench/readers.py, bench/roofline)."""
from bench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, ("sl_decode_kernel",))
