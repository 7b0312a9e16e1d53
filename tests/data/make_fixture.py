#!/usr/bin/env python
"""Writes fixture.deflated beside this script: the uncompressed size as
an 8-byte little-endian integer, then the raw level-9 deflate (no zlib
header) of ~22 KB of Lisp-like text from a seeded generator.

    python tests/data/make_fixture.py
"""
import os
import random
import struct
import zlib

WORDS = ("defun let loop when unless setf incf aref logand ash ldb byte "
         "declare fixnum octets window bits state huffman table code length "
         "distance literal block stored dynamic fixed emit copy offset "
         "buffer input output end start").split()


def text(seed: int = 3, size: int = 22_000) -> bytes:
    rng = random.Random(seed)
    lines = []
    while sum(map(len, lines)) < size:
        depth = rng.randrange(1, 6)
        body = " ".join(rng.choice(WORDS) for _ in range(rng.randrange(2, 9)))
        lines.append("  " * depth + "(" + body + " " +
                     str(rng.randrange(1 << 16)) + ")" * rng.randrange(1, 4)
                     + "\n")
    return "".join(lines).encode()


if __name__ == "__main__":
    data = text()
    co = zlib.compressobj(9, zlib.DEFLATED, -15)
    payload = co.compress(data) + co.flush()
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixture.deflated")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(data)) + payload)
