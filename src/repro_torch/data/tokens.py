"""Deterministic synthetic LM token pipeline (the port's copy of
``repro.data.tokens``; numpy, so its tokens equal the reference's).

Stateless and seekable: batch t is a pure function of (seed, step), so
checkpoint/restart needs only the step counter (no iterator state), and
every data-parallel host slices its own shard.

The stream is a mixture of Zipf-distributed unigrams and short Markov
motifs so losses decrease plausibly during the example runs.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab: int
    batch: int             # global batch
    seq_len: int
    seed: int = 0


def global_batch(cfg: TokenPipelineConfig, step: int):
    """(tokens (B, S), labels (B, S)) int32 for the given step."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, 0xC0FFEE])
    )
    B, S, V = cfg.batch, cfg.seq_len, cfg.vocab
    # zipf-ish unigrams
    ranks = rng.zipf(1.3, size=(B, S + 1)).astype(np.int64)
    toks = np.minimum(ranks - 1, V - 1)
    # motif injection: repeat short spans to create learnable structure
    n_motifs = max(S // 64, 1)
    for b in range(B):
        starts = rng.integers(0, max(S - 16, 1), n_motifs)
        for s in starts:
            span = min(8, S - int(s) - 1)
            if span > 2:
                toks[b, s + 1 : s + 1 + span] = toks[b, s : s + span]
    tokens = toks[:, :-1].astype(np.int32)
    labels = toks[:, 1:].astype(np.int32)
    return tokens, labels


def host_batch(cfg: TokenPipelineConfig, step: int, host_id: int,
               n_hosts: int):
    """This host's shard of the global batch (contiguous rows)."""
    if cfg.batch % n_hosts:
        raise ValueError(f"batch {cfg.batch} does not split over "
                         f"{n_hosts} hosts")
    tokens, labels = global_batch(cfg, step)
    per = cfg.batch // n_hosts
    sl = slice(host_id * per, (host_id + 1) * per)
    return tokens[sl], labels[sl]
