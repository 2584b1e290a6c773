"""Dispatch of the symbol histogram (K5) and the Huffman decode (K6): a
CUDA tensor launches the kernel, a CPU tensor takes the plain version."""
from __future__ import annotations

import numpy as np
import torch

from . import kernel, ref
from .. import use_kernel


def symbol_histogram(sym: torch.Tensor) -> torch.Tensor:
    if use_kernel(sym, "symbol_histogram"):
        return kernel.symbol_histogram(sym)
    return ref.symbol_histogram(sym)


def huffman_decode(stream: torch.Tensor, tab: torch.Tensor, nbits: int,
                   n: int, fill: int):
    if use_kernel(stream, "huffman_decode"):
        return kernel.huffman_decode(stream, tab, nbits, n, fill)
    return ref.huffman_decode(stream, tab, nbits, n, fill)


def huffman_decode_section(ln, codes, data: bytes, n: int, device):
    """One Huffman section's decode on ``device``: K6's tables
    (``ref.decode_tables``) and the section's bytes, zero-padded as the
    kernel reads them, in one upload, then ``huffman_decode``.  Returns
    (symbols uint8 (n,) on ``device``, total, past): the symbols the
    chain decodes before the stream's end, and how many bits past the
    end it stopped, or None where it met a window no code starts."""
    tab, fill = ref.decode_tables(ln, codes)
    nbytes = len(data)
    host = np.zeros(ref.TABLE_LEN + (nbytes + 3) // 4 + 2, np.int32)
    host[:ref.TABLE_LEN] = tab
    body = host.view(np.uint8)[4 * ref.TABLE_LEN:]
    body[:nbytes] = np.frombuffer(data, np.uint8)
    buf = torch.from_numpy(host).to(device)
    sym, status = huffman_decode(buf[ref.TABLE_LEN:].view(torch.uint8),
                                 buf[:ref.TABLE_LEN], 8 * nbytes, n, fill)
    total, state = status.tolist()
    return sym, total, None if state == ref.STUCK else state
