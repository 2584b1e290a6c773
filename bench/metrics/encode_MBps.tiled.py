"""API (core/compressor.py): the tiled write's rate, raw bytes (u + v,
float32, 10^6 B a MB) of every ``compress`` that finished in the window
over the wall time of those calls, as ``encode_MBps`` is taken in the
monolithic write.  Per layer: on the host of a one-card machine its runs
spread wider than the largest bound an end-to-end metric may have."""


def read(ctx):
    secs = sum(c.seconds for c in ctx["calls"])
    if secs <= 0:
        return None
    return sum(c.raw_bytes for c in ctx["calls"]) / 1e6 / secs
