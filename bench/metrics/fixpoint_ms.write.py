"""Monolithic fixpoint (core/pipeline.py): eb derivation, quantize and
predict, and the verify rounds, ms per chunk written.  Each of the three
spans ends with a device synchronize (``obs.device_sync``)."""
from bench.readers import span_ms_per_call


def read(ctx):
    return span_ms_per_call(ctx, ("pipeline.derive_eb",
                                  "pipeline.quantize_predict",
                                  "pipeline.verify_round"))
