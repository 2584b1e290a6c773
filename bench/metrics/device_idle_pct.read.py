"""Device: share of the traced window in which a card ran no kernel and
no copy, averaged over the cards (bench/profiling.py)."""
from bench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
