"""Monolithic decode (core/pipeline.py::decode_payload): the residuals'
upload and the SL decode (K3; ends in a device synchronize), then the
lossless scatter, the reconstruction and its download, ms per chunk
read."""
from bench.readers import span_ms_per_call


def read(ctx):
    return span_ms_per_call(ctx, ("decode.sl", "decode.reconstruct"))
