"""Device resolver vs host oracle: the two-phase decode must reproduce
the reference's byte-serial copy semantics exactly (deflate.lisp:244-359),
including deep overlapping copies and window-crossing references."""

import zlib

import numpy as np
import pytest

from tbz import reference
from tbz.ops import resolve
from tbz.tape import TokenTape

from util import corpus, fixture, raw_deflate


def roundtrip(data: bytes, level: int = 9) -> None:
    payload = raw_deflate(data, level)
    res = reference.tokenize_host(payload)
    got = resolve.resolve_bytes(res.tape, payload)
    assert got == data


def test_fixture():
    _, payload = fixture()
    res = reference.tokenize_host(payload)
    got = resolve.resolve_bytes(res.tape, payload)
    assert got == zlib.decompressobj(-15).decompress(payload)


def test_corpus_levels():
    data = corpus(21, 1 << 16)
    for level in (0, 1, 6, 9):  # level 0 = stored blocks
        roundtrip(data, level)


def test_deep_overlap_chain():
    # 'a' then max-length dist-1 matches repeatedly: chain depth ~ output len.
    data = b"a" * 100000
    roundtrip(data)


def test_overlap_distances():
    # Each distance class in the reference's specialized copy (1,2,3,4,8,>4).
    for d in (1, 2, 3, 4, 5, 7, 8, 9, 100):
        data = (b"0123456789abcdef"[:d]) * 500
        roundtrip(data)


def test_stored_plus_huffman_mix():
    data = bytes(np.random.default_rng(5).integers(0, 256, 70000,
                                                   dtype=np.uint8))
    # level 1 on random data produces stored blocks mixed with huffman
    roundtrip(data, 1)
    roundtrip(data, 0)


def test_window_carry():
    """Second stream references history produced before it (window carry)."""
    rng = np.random.default_rng(6)
    hist = bytes(rng.integers(32, 127, 40000, dtype=np.uint8))
    tail = hist[-1000:]
    # Compress 'tail again' with a preset dictionary = prior history.
    co = zlib.compressobj(9, zlib.DEFLATED, -15, zdict=hist)
    payload = co.compress(tail * 3) + co.flush()
    res = reference.tokenize_host(payload, window_len=len(hist))
    got = resolve.resolve_bytes(res.tape, payload, window=hist)
    do = zlib.decompressobj(-15, zdict=hist)
    assert got == do.decompress(payload)


def test_empty_stream():
    payload = raw_deflate(b"")
    res = reference.tokenize_host(payload)
    got = resolve.resolve_bytes(res.tape, payload)
    assert got == b""


def test_shape_bucket_reuse():
    """Different inputs land in the same padded shape class (jit cache)."""
    for seed in range(4):
        data = corpus(seed, 5000)
        roundtrip(data)
