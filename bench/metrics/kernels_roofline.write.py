"""Kernels (kernels/*, csrc/*.cu) of a monolithic write: K1, K4, K3, K2
and K5 together, percent of the card's roofline (bench/readers.py,
bench/roofline)."""
from bench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, (
        "lorenzo_residual_kernel", "sl_step_batched_kernel",
        "sl_decode_kernel", "verify_faces_kernel",
        "symbol_histogram_kernel"))
