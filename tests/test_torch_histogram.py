"""K5's counting on the CPU: a numpy transcription of csrc/entropy.cu.

The kernel counts symbols 1..4 as byte-lane masks of 32-bit words, sends
symbols >= 5 to per-warp shared bins, derives bin 0 as n minus the other
bins, and counts a row's unaligned head and tail byte by byte.  Here the
same word arithmetic, over every word of rows with any alignment, must
give ``np.bincount``; and the source's constants must keep a byte lane
from carrying before it is folded.  The kernel itself runs only on the
card (tests/test_torch_cuda.py holds it against the plain version).
"""
import pytest

pytest.importorskip("torch")

import re
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc/entropy.cu"
U = np.uint64
LANES = U(0x01010101)
M32 = U(0xFFFFFFFF)


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         SRC.read_text()).group(1))


def _count_words(w):
    """entropy.cu ``count_word`` over an array of 32-bit words: (counts
    of symbols 1..4 from the lane masks, the symbols sent to the shared
    bins)."""
    w = np.asarray(w, U)
    hi = (((w & U(0x7F7F7F7F)) + U(0x03030303)) | w) & U(0xF8F8F8F8)
    big = (((hi & U(0x7F7F7F7F)) + U(0x7F7F7F7F)) | hi) & U(0x80808080)
    lanes = [(w >> U(8 * k)) & U(0xFF) for k in range(4)]
    atom = np.concatenate([lane[((big >> U(8 * k + 7)) & U(1)) == 1]
                           for k, lane in enumerate(lanes)])
    w = w & ~((big >> U(7)) * U(0xFF)) & M32
    t = w >> U(1)
    masks = [w & ~t & LANES, ~w & t & LANES, w & t & LANES,
             (w >> U(2)) & LANES]
    # __dp4a(a, 0x01010101, c): the four byte lanes summed
    small = [int(sum(((m >> U(8 * k)) & U(0xFF)).sum() for k in range(4)))
             for m in masks]
    return small, atom


def _kernel_row(row: np.ndarray):
    """The kernel's counts of one row that starts at byte offset
    ``row.ctypes.data % 16`` of a 16-byte aligned buffer."""
    n = len(row)
    head = min((16 - row.ctypes.data % 16) % 16, n)
    nvec = (n - head) // 16
    words = row[head:head + 16 * nvec].view("<u4")
    ends = np.concatenate([row[:head], row[head + 16 * nvec:]])
    small, atom = _count_words(words)
    small2, atom2 = _count_words(ends.astype(U))   # one byte a word
    hist = np.zeros(256, np.int64)
    hist[1:5] = np.add(small, small2)
    np.add.at(hist, np.concatenate([atom, atom2]).astype(np.int64), 1)
    hist[0] = n - hist[1:].sum()
    return hist


@pytest.mark.parametrize("kind", ["uniform", "small", "zeros", "only >= 5",
                                  "scf-like"])
def test_word_counting_transcription_equals_bincount(kind):
    rng = np.random.default_rng(len(kind))
    n = 70_001
    p = {"small": np.r_[np.full(5, 0.19), np.full(251, 0.05 / 251)],
         "scf-like": np.r_[[0.6248, 0.1606, 0.17, 0.0206, 0.0228, 0.0002,
                            0.0006, 0.00003, 0.0001], np.zeros(247)]}
    if kind in p:
        pk = p[kind] / p[kind].sum()
        flat = rng.choice(256, 64 + 3 * n, p=pk).astype(np.uint8)
    elif kind == "uniform":
        flat = rng.integers(0, 256, 64 + 3 * n).astype(np.uint8)
    elif kind == "zeros":
        flat = np.zeros(64 + 3 * n, np.uint8)
    else:
        flat = rng.integers(5, 256, 64 + 3 * n).astype(np.uint8)
    buf = np.zeros(len(flat) + 16, np.uint8)
    base = (16 - buf.ctypes.data % 16) % 16
    aligned = buf[base:base + len(flat)]
    aligned[:] = flat
    for offset in (0, 3, 13):                      # the rows' alignment
        for r in range(3):
            row = aligned[offset + r * n: offset + (r + 1) * n]
            assert np.array_equal(_kernel_row(row),
                                  np.bincount(row, minlength=256)), \
                (kind, offset, r)


def test_lanes_fold_before_they_carry():
    """A byte lane gains at most one count a word: kFoldEvery loop trips
    of kUnroll 16-byte loads (four words each), plus a head and a tail
    byte, must stay below 256 before ``fold``."""
    per_trip = _const("kUnroll") * 4
    assert _const("kFoldEvery") * per_trip + 2 < 256
    assert _const("kSmall") == 5 and _const("kThreads") % 32 == 0
