"""Tiled driver (core/tiling.py): the seam-agreed verify loop over the
unit chunks (span ``tiling.fixpoint``), ms per chunk written.  Its
rounds return host masks from every worker, so the span ends after its
device work."""
from bench.readers import span_ms_per_call


def read(ctx):
    return span_ms_per_call(ctx, ("tiling.fixpoint",))
