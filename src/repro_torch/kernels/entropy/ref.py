"""Plain PyTorch version of K5: one bincount over row-offset keys (row i
counts into bins [256 i, 256 i + 256)), as the JAX package's numpy
mirror ``backend._symbol_histogram_np`` does.  Any device."""
from __future__ import annotations

import numpy as np
import torch


def symbol_histogram(sym: torch.Tensor) -> torch.Tensor:
    B = sym.shape[0]
    rows = torch.arange(B, dtype=torch.int64, device=sym.device)[:, None]
    keys = sym.to(torch.int64) + (rows << 8)
    counts = torch.bincount(keys.reshape(-1), minlength=B * 256)
    return counts.reshape(B, 256).to(torch.int32)


# ----------------------------------------------------------------------
# K6: the Huffman decode of one symbol section
# ----------------------------------------------------------------------

# csrc/huffman.cu's constants and the layout of its int32 decode tables
# (``decode_tables`` writes them)
SUB_BITS = 128                  # bits a subsequence
ENTRIES = 16                    # entry offsets a subsequence (L_MAX)
STUCK = ENTRIES                 # the state of a chain that met no code
PEEK_BITS = 11                  # first-level table: 2^11 windows
MAX_LEN = 16
LONG = 1 << 13                  # a longer code starts with the prefix
FIRST = 1 << PEEK_BITS          # first canonical code of each length
COUNT = FIRST + MAX_LEN + 1     # codes of each length
BASE = COUNT + MAX_LEN + 1      # their first index in SORTED
SORTED = BASE + MAX_LEN + 1     # symbols in canonical order
TABLE_LEN = SORTED + 256


def decode_tables(ln, codes) -> tuple[np.ndarray, int]:
    """K6's int32 decode tables of a checked length table ``ln`` (int32
    [256], at most MAX_LEN) and its canonical ``codes``, and the symbol
    whose code is all zeros (what the host decode reads in the zero
    padding past a stream)."""
    present = np.nonzero(ln)[0]
    order = present[np.lexsort((present, ln[present]))]  # canonical order
    tab = np.zeros(TABLE_LEN, np.int32)
    for s in present:
        ln_s, code = int(ln[s]), int(codes[s])
        if ln_s <= PEEK_BITS:
            span = PEEK_BITS - ln_s
            tab[code << span: (code + 1) << span] = s | ln_s << 8
        else:
            tab[code >> (ln_s - PEEK_BITS)] |= LONG
    by_len = ln[order]
    for ln_s in range(1, MAX_LEN + 1):
        at = int(np.searchsorted(by_len, ln_s))
        cnt = int(np.searchsorted(by_len, ln_s, side="right")) - at
        tab[COUNT + ln_s] = cnt
        tab[BASE + ln_s] = at
        tab[FIRST + ln_s] = codes[order[at]] if cnt else 0
    tab[SORTED: SORTED + len(order)] = order
    return tab, int(order[0])


def _windows(stream, pos):
    """16-bit MSB-first windows of the byte stream at bit positions."""
    i = pos >> 3
    w24 = (stream[i] << 16) | (stream[i + 1] << 8) | stream[i + 2]
    return (w24 >> (8 - (pos & 7))) & 0xFFFF


def _codeword(tab, w16):
    """symbol | length << 8 of the codeword starting each window (length
    0: no code), the kernel's first-level lookup and canonical compare."""
    e = tab[w16 >> (16 - PEEK_BITS)]
    long = (e & LONG) != 0
    out = torch.where(long, 0, e & 0x1FFF)
    for ln in range(PEEK_BITS + 1, MAX_LEN + 1):
        d = (w16 >> (16 - ln)) - tab[FIRST + ln]
        hit = long & (out == 0) & (d >= 0) & (d < tab[COUNT + ln])
        sym = tab[SORTED + (tab[BASE + ln] + d).clamp(0, 255)]
        out = torch.where(hit, sym | (ln << 8), out)
    return out


def _walk(stream, tab, pos, end, emit=None):
    """Every chain from bit ``pos`` while it is below its ``end`` (the
    kernel's walk, all chains at once).  Returns (pos: the first codeword
    start >= end, or the stuck window; symbols decoded; stuck).
    ``emit(chains, k, symbols)`` takes each step's k-th symbols."""
    pos = pos.clone()
    count = torch.zeros_like(pos)
    stuck = torch.zeros_like(pos, dtype=torch.bool)
    live = pos < end
    while bool(live.any()):
        e = _codeword(tab, _windows(stream, torch.where(live, pos, 0)))
        ln = e >> 8
        stuck |= live & (ln == 0)
        live &= ln > 0
        if emit is not None:
            emit(live, count, e & 0xFF)
        count += live
        pos += torch.where(live, ln, 0)
        live &= pos < end
    return pos, count, stuck


def _then(a, maps):
    """Apply the maps ``a`` (..., 16) and then ``maps``: symbols add, the
    state is the second map's; a stuck entry stays stuck."""
    st = a & 0xFF
    nxt = torch.gather(maps, -1, st.clamp(max=ENTRIES - 1))
    return torch.where(st == STUCK, a, (a & ~0xFF) + nxt)


def huffman_decode(stream, tab, nbits: int, n: int, fill: int,
                   sub_bits: int = SUB_BITS):
    """K6's phases in plain PyTorch: split into ``sub_bits`` subsequences,
    speculative decode from each of the 16 entry offsets (the transfer
    maps), resynchronisation by a scan of the maps (here one Hillis-Steele
    over all of them; the kernel scans blocks of 64, then their
    composites), each subsequence's entry offset and first symbol, and the
    final pass.  stream: the section's bytes, zero-padded by >= 8 bytes;
    tab: the int32 decode tables.  Returns (symbols uint8 (n,), status
    int64 (2,): the symbols before the chain's end, and its state: the
    exit offset past nbits, or 16 where it is stuck)."""
    dev = stream.device
    stream = stream.to(torch.int64)
    tab = tab.to(torch.int64)
    T = -(-nbits // sub_bits)
    out = torch.zeros(n, dtype=torch.uint8, device=dev)
    top = torch.zeros((), dtype=torch.int64, device=dev)
    if T:
        base = torch.arange(T, dtype=torch.int64, device=dev) * sub_bits
        end = (base + sub_bits).clamp(max=nbits)[:, None]
        # speculative decode: (subsequence, entry offset) -> symbols << 8
        # | exit offset past the subsequence's end (or STUCK)
        start = base[:, None] + torch.arange(ENTRIES, device=dev)
        pos, count, stuck = _walk(stream, tab, start, end.expand(-1, ENTRIES))
        maps = (count << 8) | torch.where(stuck, STUCK, pos - end)
        # resynchronisation: inclusive scan of the maps
        d = 1
        while d < T:
            maps = torch.cat([maps[:d], _then(maps[:-d], maps[d:])])
            d *= 2
        top = maps[-1, 0]
        entries = torch.cat([top.new_zeros(1), maps[:-1, 0]])
        # final pass from each subsequence's true entry
        live = (entries & 0xFF) != STUCK
        first = (entries >> 8)[live]

        def emit(step, k, sym):
            at = first[:, None] + k
            keep = step & (at < n)
            out[at[keep]] = sym[keep].to(torch.uint8)

        _walk(stream, tab, (base + (entries & 0xFF))[live][:, None],
              end[live], emit)
    total, state = int(top >> 8), int(top & 0xFF)
    out[total:] = 0 if state == STUCK else fill
    return out, torch.tensor([total, state], dtype=torch.int64, device=dev)
