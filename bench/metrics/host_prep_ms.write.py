"""API (core/compressor.py, core/pipeline.py): the monolithic write's host
set-up (validation, float32 copy, eb factor, fixed point, the plan), the
uploads of the fixed-point and raw fields (ending in a device
synchronize) and the lossless mask's download, ms per chunk written."""
from bench.readers import span_ms_per_call


def read(ctx):
    return span_ms_per_call(ctx, ("compressor.prepare", "pipeline.upload",
                                  "pipeline.download"))
