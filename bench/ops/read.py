"""The read op: a whole ``decompress`` of a container written in
set-up, back to back.  Its rate is ``decode_MBps``; the check judges
every answer of the window (``bench/reference``)."""
from __future__ import annotations

RATE = "decode_MBps"


def setup(program, pool, cfg, order, device):
    """Write the pool's containers and warm one decode; the containers
    are the op's state."""
    blobs = [program.compress(u, v, cfg, device=device)[0] for u, v in pool]
    program.decompress(blobs[order[0]], device=device)
    return blobs


def call(program, state, pool, c, cfg, device):
    return program.decompress(state[c], device=device), len(state[c]), None


def end_to_end(done) -> dict:
    secs = sum(c.seconds for c in done)
    raw = sum(c.raw_bytes for c in done)
    return {RATE: raw / 1e6 / secs} if secs > 0 else {}


def check(ctx) -> dict:
    from bench import harness
    from bench.reference import judge

    eb = ctx["config"]["compressor"]["eb"]
    mode = ctx["config"]["compressor"]["mode"]
    judged = [judge.judge(*ctx["pool"][call_.chunk], *out, eb, mode,
                          ctx["device"])
              for call_, out in zip(ctx["calls"], ctx["answers"])
              if out is not None]
    return harness.judged_numbers(ctx["calls"], judged)
