"""The write op: ``compress`` of a chunk, back to back.

Its rate is ``encode_MBps``, and it reports ``ratio``: all raw bytes over
all container bytes (``len(blob)``) of the window's calls.  The check
decodes the first container of each sampled chunk with the program's
``decompress`` and judges the field (``bench/reference``); where the
configuration writes a track index, it reads the index from the same
container (``repro_torch.analysis.load_track_index``, the footer alone)
and holds its crossed faces, counted a frame and a slab, to the faces
the reference finds crossed in the decoded field."""
from __future__ import annotations

import random
import sys

import numpy as np

RATE = "encode_MBps"


def setup(program, pool, cfg, order, device):
    """Warm one call of the cell's shape; the op keeps no state."""
    program.compress(*pool[order[0]], cfg, device=device)


def call(program, state, pool, c, cfg, device):
    blob, stats = program.compress(*pool[c], cfg, device=device)
    return blob, len(blob), stats


def end_to_end(done) -> dict:
    out = {}
    secs = sum(c.seconds for c in done)
    raw = sum(c.raw_bytes for c in done)
    if secs > 0:
        out[RATE] = raw / 1e6 / secs
    if done:
        out["ratio"] = raw / sum(c.out_bytes for c in done)
    return out


def index_faces_differ(blob, planes, H: int, W: int) -> int:
    """Sum over frames and slabs of |crossed faces in the container's
    track index - crossed faces of the decoded field|; -1 where the
    container holds no readable index."""
    from bench.reference import faces

    try:
        from repro_torch.analysis import load_track_index

        source, _, idx = load_track_index(blob)
        source.close()
        fids = np.unique(np.asarray(idx.seg_fid, np.int64).reshape(-1))
    except Exception as e:  # noqa: BLE001 - an index that cannot be read
        print(f"check: track index unreadable: {e!r}", file=sys.stderr)
        return -1
    fs, fb = faces.plane_sizes(H, W)
    t, r = np.divmod(fids, fs + fb)
    ref = [(planes["slice_per_frame"], t[r < fs]),
           (planes["slab_per_slab"], t[r >= fs])]
    differ = 0
    for want, ts in ref:
        got = np.bincount(ts, minlength=len(want)) if len(ts) else \
            np.zeros(len(want), np.int64)
        if len(got) > len(want):        # a face beyond the field
            differ += int(got[len(want):].sum())
            got = got[:len(want)]
        differ += int(np.abs(got - np.asarray(want, np.int64)).sum())
    return differ


def check(ctx) -> dict:
    from bench import harness
    from bench.reference import judge

    config, mix, device = ctx["config"], ctx["mix"], ctx["device"]
    eb, mode = config["compressor"]["eb"], config["compressor"]["mode"]
    with_index = bool(config["compressor"].get("track_index")) and \
        bool(config.get("tiling"))
    first, differ = {}, 0
    for call_, blob in zip(ctx["calls"], ctx["answers"]):
        if blob is None:
            continue
        ref = first.setdefault(call_.chunk, blob)
        differ += blob != ref
    chunks = sorted(first)
    rng = random.Random(int(ctx["seed"]))
    sample = sorted(rng.sample(chunks, min(mix["check_chunks"],
                                           len(chunks))))
    judged, index_differ = [], 0
    for c in sample:
        u, v = ctx["pool"][c]
        try:
            ur, vr = ctx["decompress"](first[c], device=device)
        except Exception as e:  # noqa: BLE001 - a container that fails
            print(f"check: decode of chunk {c} raised {e!r}",
                  file=sys.stderr)
            ur = vr = None
        j = judge.judge(u, v, ur, vr, eb, mode, device, planes=with_index)
        judged.append(j)
        if with_index:
            if not j["shape_ok"]:
                index_differ = -1
            elif index_differ >= 0:
                n = index_faces_differ(first[c], j, *u.shape[1:])
                index_differ = -1 if n < 0 else index_differ + n
    numbers = harness.judged_numbers(ctx["calls"], judged)
    numbers["repeat_bytes_differ"] = (int(differ), 0, "<=")
    if with_index:
        numbers["index_faces_differ"] = (index_differ, 0, "==")
    return numbers
