"""Codec (core/entropy.py, core/encode.py): symbolize and pack, ms per
chunk written.  Both spans end on host data (the packed sections and
the container bytes)."""
from bench.readers import span_ms_per_call


def read(ctx):
    return span_ms_per_call(ctx, ("pipeline.symbolize", "pipeline.pack"))
