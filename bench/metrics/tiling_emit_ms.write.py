"""Tiled emission and track index (core/tiling.py, analysis/index.py):
the final encode of every unit with its trajectory segments (span
``tiling.unit_payloads``, which holds ``tiling.entropy_fragments`` when
the device codec runs) and the container writer (``tiling.write_units``),
ms per chunk written.  Both end on host data."""
from bench.readers import span_ms_per_call


def read(ctx):
    return span_ms_per_call(ctx, ("tiling.unit_payloads",
                                  "tiling.write_units"))
