"""Codec (core/encode.py): the container's unpack (codec, header, every
section, the Huffman decode of the device codec's included) and the
parse of the sections into residual streams, ms per chunk read."""
from bench.readers import span_ms_per_call


def read(ctx):
    return span_ms_per_call(ctx, ("decode.unpack", "decode.parse"))
