"""K6's algorithm on the CPU: the plain version of the card's Huffman
decode (kernels/entropy/ref.py: split, speculative decode from every
entry offset, resynchronisation by a scan of the transfer maps, offsets,
final pass), through the card route ``entropy.decode_on``, against the
host decode (``encode.huffman_decode`` behind ``_decode_section``), and
the host decode against the JAX package's on the same cases.

Every case must give the host's symbols, or its ContainerError where the
host raises.  Subsequences of 16 bits put a resynchronisation at almost
every codeword; 128 is the kernel's.  K6 itself runs only on the card:
tests/test_torch_cuda_huffman.py holds it to the same cases.
"""
import functools

import pytest

pytest.importorskip("torch")

import numpy as np
import torch

from huffman_cases import CASES, host_decode, padded, tables
from repro.core import encode as r_encode
from repro_torch.core import encode, entropy
from repro_torch.kernels.entropy import ref


@pytest.mark.parametrize("sub_bits", [16, 128])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_decode_equals_host(name, sub_bits, monkeypatch):
    monkeypatch.setattr(ref, "huffman_decode", functools.partial(
        ref.huffman_decode, sub_bits=sub_bits))
    ln, data, n = CASES[name]()
    want, err = host_decode(ln, data, n)
    # the port's host decode is the reference's, stuck windows, zero
    # padding and errors included
    meta = {"enc": "huff", "dtype": "uint8", "shape": [n],
            "lengths": np.asarray(ln, np.uint8).tobytes()}
    if err is not None:
        with pytest.raises(r_encode.ContainerError):
            r_encode._decode_section("sym_u", meta, data)
    else:
        assert np.array_equal(r_encode._decode_section("sym_u", meta, data),
                              want)
    ln32 = np.asarray(ln, np.int32)
    if err is not None:
        with pytest.raises(err):
            entropy.decode_on(torch.device("cpu"), ln32, data, n)
        return
    got = entropy.decode_on(torch.device("cpu"), ln32, data, n)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize("name,stuck,raises", [
    ("damaged", True, False), ("damaged-scalar", True, False),
    ("truncated", False, False), ("truncated-scalar", False, True),
    ("exact-end-plus-one", False, False), ("exact-end-plus-two", False, True),
    ("empty-stream-padding", False, False), ("flat8", False, False)])
def test_cases_reach_the_paths_they_name(name, stuck, raises):
    """The damaged streams' true chains meet an unmapped window, the
    truncated and empty ones end before n symbols, and the host raises
    only where n < 2048 and a symbol starts past the end."""
    ln, data, n = CASES[name]()
    tab, fill = tables(ln)
    sym, status = ref.huffman_decode(padded(data), torch.as_tensor(tab),
                                     8 * len(data), n, fill)
    total, state = status.tolist()
    assert (state == ref.STUCK) == stuck
    assert (total < n) == (name != "flat8")
    assert (host_decode(ln, data, n)[1] is not None) == raises


def test_tables_match_the_host_peek_table():
    """Every 16-bit window decodes to the host peek table's (symbol,
    length) through K6's first-level table and canonical compare."""
    from huffman_cases import LEN16, SPARSE

    for ln in (LEN16, SPARSE, np.asarray(CASES["skewed"]()[0])):
        ln32 = np.asarray(ln, np.int32)
        codes, _ = encode.canonical_codes(ln32)
        peek, plen = encode._peek_tables(ln32, codes, 16)
        tab, fill = tables(ln32)
        e = ref._codeword(torch.as_tensor(tab, dtype=torch.int64),
                          torch.arange(1 << 16))
        assert np.array_equal((e & 0xFF).numpy(), peek)
        assert np.array_equal((e >> 8).numpy(), plen)
        assert fill == peek[0]


def test_no_symbols_no_device_work():
    """n = 0 returns an empty array before any upload, on any device."""
    for dev in (None, "cpu", "cuda"):
        got = entropy.decode_symbols(np.full(256, 8, np.uint8), b"\x00", 0,
                                     device=dev)
        assert got.dtype == np.uint8 and got.shape == (0,)
