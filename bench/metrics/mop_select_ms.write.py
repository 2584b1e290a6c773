"""Monolithic fixpoint (core/mop.py): the MoP selection inside each
quantize-predict pass (tile histograms on the device, their copy to the
host, the float64 rate model there), ms per chunk written."""
from bench.readers import span_ms_per_call


def read(ctx):
    return span_ms_per_call(ctx, ("mop.select",))
