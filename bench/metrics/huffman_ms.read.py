"""Codec (core/entropy.py): the host Huffman decode of the device codec's
symbol sections (inside the unpack), ms per chunk read."""
from bench.readers import span_ms_per_call


def read(ctx):
    return span_ms_per_call(ctx, ("decode.huffman",))
