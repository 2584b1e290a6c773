"""Monolithic fixpoint: verify rounds per chunk written (the program's
counter ``pipeline.verify_rounds``; each round forces the vertices of
the faces and values that broke a guarantee and decodes again)."""
from bench.readers import per_call


def read(ctx):
    return per_call(ctx, ctx["counters"].get("pipeline.verify_rounds"))
