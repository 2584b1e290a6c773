"""Batched serving launcher: prefill + decode with continuous batching.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi_6b --smoke \
        --requests 16 --batch 4 --prompt-len 32 --gen-len 16 [--device cpu]

The port of ``repro.launch.serve`` (same flags and defaults, plus
``--device``: the CUDA device unless ``--device cpu`` is given).  A fixed
pool of ``--batch`` slots decodes in lockstep, one batch-1 cache per
slot; finished requests free their slot and the next queued request is
prefilled into it (continuous batching).  Reports per-phase latency and
decode tokens/sec.  Works for every decoder arch (dense/moe/ssm/hybrid/
vlm); enc-dec (whisper) serves one utterance batch per prefill.

Unlike the JAX launcher, the prefill cache is carried whole into the
padded decode cache (``pad_cache``): the hybrid family's Mamba ``conv``
and ``ssm`` states too, not only ``k`` / ``v`` / ``length``.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .. import configs as C
from ..core.compressor import resolve_device
from ..models import layers as L
from ..models.transformer import build_model


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1_5_0_5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    return ap.parse_args(argv)


def pad_cache(model, cache, batch, max_len, **init_kw):
    """The prefill ``cache`` copied into ``model.init_cache(batch,
    max_len)``: ``k`` / ``v`` fill the first ``length`` positions (and the
    first KV heads of a head-padded cache), every other state (``length``,
    Mamba ``conv`` / ``ssm``, RWKV states, cross-attention ``ek`` / ``ev``)
    is copied whole.  The prefill cache stays as it was."""
    full = model.init_cache(batch, max_len, **init_kw)
    for key, t in cache.items():
        if key in ("k", "v"):
            dst = full[key][:, :, :t.shape[2], :t.shape[3]]
            dst.copy_(L.quantize_kv(t, dst.dtype))
        elif full[key].shape != t.shape:
            raise ValueError(f"cache {key!r}: prefill {tuple(t.shape)} != "
                             f"decode {tuple(full[key].shape)}")
        else:
            full[key].copy_(t)
    return full


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _greedy(logits):
    return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)


def _serve_encdec(args, cfg, model, rng, dev):
    frames = torch.from_numpy(rng.normal(
        0, 1, (args.batch, args.prompt_len, cfg.d_model)
    ).astype(np.float32)).to(dev)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, (args.batch, 8)).astype(np.int32)).to(dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill({"frames": frames, "tokens": toks})
    cache = pad_cache(model, cache, args.batch, args.max_len,
                      enc_len=args.prompt_len)
    _sync(dev)
    t1 = time.perf_counter()
    out = []
    for _ in range(args.gen_len):
        nxt = _greedy(logits)
        out.append(nxt)
        logits, cache = model.decode_step({"tokens": nxt}, cache)
    _sync(dev)
    t2 = time.perf_counter()
    gen = torch.cat(out, dim=1).cpu().numpy()
    rows = range(args.batch)
    return {"tokens": {r: gen[r] for r in rows},
            "prompts": {r: {"frames": frames[r:r + 1].cpu(),
                            "tokens": toks[r:r + 1].cpu()} for r in rows},
            "last_logits": {r: logits[r:r + 1] for r in rows},
            "requests": args.batch, "prefills": 1,
            "decoded_tokens": args.gen_len * args.batch,
            "seconds": t2 - t0, "prefill_seconds": t1 - t0,
            "decode_seconds": t2 - t1}


def run(args, model=None) -> dict:
    """Serve ``args.requests`` requests; returns each request's prompt and
    generated tokens (``tokens[rid]``, ``gen_len`` of them: the greedy
    token fed to each decode step), the last decode step's logits of each
    request, counts and host-clock seconds (synchronized on CUDA).

    ``model`` (optional) is a built model on ``args.device`` to serve in
    place of ``--arch`` / ``--smoke`` (e.g. one carrying converted
    weights, or another dtype); by default the architecture's model is
    built from ``args.seed``."""
    dev = resolve_device(args.device)
    if model is None:
        mod = C.get(args.arch)
        model = build_model(mod.SMOKE if args.smoke else mod.CONFIG,
                            device=dev, seed=args.seed)
    elif model.device.type != dev.type or (
            dev.index is not None and model.device.index != dev.index):
        raise ValueError(f"model is on {model.device}, --device is {dev}")
    cfg = model.cfg
    rng = np.random.default_rng(args.seed)
    if cfg.is_encoder_decoder:
        return _serve_encdec(args, cfg, model, rng, dev)

    def new_request():
        if cfg.embedding_inputs:
            emb = rng.normal(0, 1, (1, args.prompt_len, cfg.d_model))
            return {
                "embeds": torch.from_numpy(emb.astype(np.float32)).to(
                    dev).to(torch.bfloat16),
                "position_ids": torch.arange(
                    args.prompt_len, dtype=torch.int32, device=dev
                )[None, None].expand(3, 1, args.prompt_len),
            }
        toks = rng.integers(0, cfg.vocab, (1, args.prompt_len))
        return {"tokens": torch.from_numpy(toks.astype(np.int32)).to(dev)}

    queue = list(range(args.requests))
    slots = [None] * args.batch   # [rid, cache, logits, n generated]
    prompts, generated, last_logits = {}, {}, {}
    done = decoded_tokens = prefills = 0
    prefill_s = 0.0
    _sync(dev)
    t0 = time.perf_counter()
    while done < args.requests:
        for s in range(args.batch):
            if slots[s] is None and queue:
                rid = queue.pop(0)
                req = new_request()
                prompts[rid] = req
                t_p = time.perf_counter()
                logits, cache = model.prefill(req)
                cache = pad_cache(model, cache, 1, args.max_len)
                _sync(dev)
                prefill_s += time.perf_counter() - t_p
                slots[s] = [rid, cache, logits, 0]
                generated[rid] = []
                prefills += 1
        for s in range(args.batch):
            if slots[s] is None:
                continue
            rid, cache, logits, n = slots[s]
            nxt = _greedy(logits)
            generated[rid].append(nxt)
            if cfg.embedding_inputs:
                step_in = {"embeds": torch.zeros(
                    (1, 1, cfg.d_model), dtype=torch.bfloat16, device=dev)}
            else:
                step_in = {"tokens": nxt}
            logits, cache = model.decode_step(step_in, cache)
            decoded_tokens += 1
            n += 1
            if n >= args.gen_len:
                slots[s] = None
                last_logits[rid] = logits
                done += 1
            else:
                slots[s] = [rid, cache, logits, n]
    _sync(dev)
    dt = time.perf_counter() - t0
    return {
        "tokens": {r: torch.cat(g, dim=1)[0].cpu().numpy()
                   for r, g in generated.items()},
        "prompts": {r: {k: v.cpu() for k, v in p.items()}
                    for r, p in prompts.items()},
        "last_logits": last_logits,
        "requests": args.requests, "prefills": prefills,
        "decoded_tokens": decoded_tokens, "seconds": dt,
        "prefill_seconds": prefill_s, "decode_seconds": dt - prefill_s,
    }


def main(argv=None):
    args = parse_args(argv)
    out = run(args)
    if C.get(args.arch).SMOKE.is_encoder_decoder:
        print(f"[serve] enc-dec prefill {out['prefill_seconds']:.3f}s, "
              f"decode {out['decoded_tokens'] / out['decode_seconds']:.1f} "
              "tok/s")
        return 0
    dt = out["seconds"]
    print(f"[serve] {out['requests']} requests, {out['prefills']} prefills, "
          f"{out['decoded_tokens']} tokens in {dt:.2f}s "
          f"({out['decoded_tokens'] / dt:.1f} tok/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
