"""Shared test helpers: bit-level stream construction and corpora."""

from __future__ import annotations

import os
import random
import zlib


class BitWriter:
    """LSB-first bit packer (inverse of tbz.bitreader.BitReader)."""

    def __init__(self):
        self.buf = 0
        self.nbits = 0
        self.out = bytearray()

    def bits(self, value: int, n: int) -> "BitWriter":
        assert 0 <= value < (1 << n)
        self.buf |= value << self.nbits
        self.nbits += n
        while self.nbits >= 8:
            self.out.append(self.buf & 0xFF)
            self.buf >>= 8
            self.nbits -= 8
        return self

    def huff(self, code: int, n: int) -> "BitWriter":
        """Write a Huffman code (MSB-first on the wire)."""
        rev = 0
        c = code
        for _ in range(n):
            rev = (rev << 1) | (c & 1)
            c >>= 1
        return self.bits(rev, n)

    def align(self) -> "BitWriter":
        if self.nbits:
            self.out.append(self.buf & 0xFF)
            self.buf = 0
            self.nbits = 0
        return self

    def raw_bytes(self, data: bytes) -> "BitWriter":
        self.align()
        self.out += data
        return self

    def bytes(self) -> bytes:
        b = bytearray(self.out)
        if self.nbits:
            b.append(self.buf & 0xFF)
        return bytes(b)


def bitstring(s: str) -> bytes:
    """Build bytes from a whitespace-separated bit string, packed LSB-first
    within each byte in the order written (the deflate-test.lisp:38-43
    convention, reimplemented)."""
    w = BitWriter()
    for ch in s:
        if ch in "01":
            w.bits(int(ch), 1)
    return w.bytes()


FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "fixture.deflated")


def fixture() -> tuple[int, bytes]:
    """(declared size, raw deflate payload) of tests/data/fixture.deflated
    (made by tests/data/make_fixture.py)."""
    with open(FIXTURE, "rb") as f:
        raw = f.read()
    return int.from_bytes(raw[:8], "little"), raw[8:]


def raw_deflate(data: bytes, level: int = 6) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    return c.compress(data) + c.flush()


def equal_freq_lengths(k: int) -> list[int]:
    """Code lengths for k equally-likely symbols forming a complete code."""
    if k == 1:
        return [1]
    import math
    d = math.ceil(math.log2(k))
    n_deep = 2 * (k - (1 << (d - 1)))
    n_shallow = k - n_deep
    return [d - 1] * n_shallow + [d] * n_deep


def write_dynamic_header(w: BitWriter, lit_lens, dist_lens) -> dict:
    """Write a dynamic-block header (post-BTYPE) encoding the given code
    lengths literally (no 16/17/18 repeat codes). Returns the canonical
    codes of the litlen/dist alphabets for writing block data.

    lit_lens must have length in [257, 288]; dist_lens in [1, 32].
    """
    import numpy as np

    from tbz import constants as C
    from tbz import huffman

    lit_lens = list(lit_lens)
    dist_lens = list(dist_lens)
    assert 257 <= len(lit_lens) <= 288 and 1 <= len(dist_lens) <= 32
    all_lens = lit_lens + dist_lens
    distinct = sorted(set(all_lens))
    cl_lens = np.zeros(19, dtype=np.int64)
    for sym, l in zip(distinct, equal_freq_lengths(len(distinct))):
        cl_lens[sym] = l
    order = list(C.CODE_LENGTH_ORDER)
    used_pos = [order.index(s) for s in distinct]
    hclen = max(4, max(used_pos) + 1)

    w.bits(len(lit_lens) - 257, 5)
    w.bits(len(dist_lens) - 1, 5)
    w.bits(hclen - 4, 4)
    for i in range(hclen):
        w.bits(int(cl_lens[order[i]]), 3)
    syms, ls, codes = huffman.canonical_codes(cl_lens)
    cl_code = {int(s): (int(c), int(l)) for s, l, c in zip(syms, ls, codes)}
    for v in all_lens:
        c, l = cl_code[v]
        w.huff(c, l)

    def codebook(lens):
        syms, ls, codes = huffman.canonical_codes(np.array(lens))
        return {int(s): (int(c), int(l)) for s, l, c in zip(syms, ls, codes)}

    return {"lit": codebook(lit_lens), "dist": codebook(dist_lens)}


# Fixed-Huffman code helpers (RFC 1951 §3.2.6).
def fixed_lit_code(sym: int) -> tuple[int, int]:
    if sym <= 143:
        return 0x30 + sym, 8
    if sym <= 255:
        return 0x190 + sym - 144, 9
    if sym <= 279:
        return sym - 256, 7
    return 0xC0 + sym - 280, 8


def corpus(seed: int = 0, size: int = 1 << 16) -> bytes:
    """Mixed compressible/incompressible test data."""
    rng = random.Random(seed)
    parts = []
    words = [b"the", b"quick", b"brown", b"fox", b"jax", b"tpu", b"deflate"]
    total = 0
    while total < size:
        k = rng.randrange(4)
        if k == 0:
            p = bytes([rng.randrange(256)]) * rng.randrange(1, 400)
        elif k == 1:
            p = os.urandom(rng.randrange(1, 200))
        elif k == 2:
            p = b" ".join(rng.choice(words) for _ in range(rng.randrange(1, 60)))
        else:
            p = bytes(range(rng.randrange(1, 256)))
        parts.append(p)
        total += len(p)
    return b"".join(parts)[:size]
