"""The five BASELINE.json correctness configs, one test each.

1. Raw DEFLATE inflate of bundled test.deflated, byte-exact
2. zlib-wrapped 1MB text (dynamic blocks + Adler-32 verify)
3. Multi-member gzip with CRC-32/ISIZE checks
4. Chunked streaming over 64KB pieces with 32KB history carry
5. Corpus sharded as independent streams across a device mesh,
   ordered gather (8 virtual devices here; same code on a real slice)
"""

import gzip as _gzip
import random
import zlib

import pytest

from tbz import api
from tbz.streaming import Decompressor

from util import corpus, fixture


def test_config1_bundled_fixture():
    size, payload = fixture()
    expect = zlib.decompressobj(-15).decompress(payload)
    assert len(expect) == size
    for backend in ("host", "device"):
        out = api.decompress(payload, "raw", backend=backend)
        assert out == expect and len(out) == size


def test_config2_zlib_1mb_text():
    words = ("lorem ipsum dolor sit amet consectetur adipiscing elit sed "
             "do eiusmod tempor incididunt ut labore et dolore").split()
    rng = random.Random(4)
    text = " ".join(rng.choice(words) for _ in range(200_000)).encode()
    text = text[:1 << 20]
    payload = zlib.compress(text, 9)
    for backend in ("host", "device"):
        assert api.decompress(payload, "zlib", backend=backend) == text


def test_config3_multimember_gzip():
    members = [corpus(i + 40, 30000 + i * 1000) for i in range(5)]
    payload = b"".join(_gzip.compress(m, 9) for m in members)
    out, info = api.decompress(payload, "gzip", with_info=True)
    assert out == b"".join(members)
    assert len(info.members) == 5
    # corrupting any member's CRC or ISIZE is caught
    bad = bytearray(payload)
    bad[-2] ^= 1  # last member ISIZE
    from tbz.errors import ChecksumError
    with pytest.raises(ChecksumError):
        api.decompress(bytes(bad), "gzip")


def test_config4_chunked_64k_history_carry():
    data = corpus(44, 3 << 20)
    payload = zlib.compress(data, 9)
    d = Decompressor("zlib")
    out = []
    for i in range(0, len(payload), 65536):
        out.append(d.decompress(payload[i:i + 65536]))
    out.append(d.flush())
    assert b"".join(out) == data and d.eof


def test_config5_sharded_streams_ordered_gather():
    import jax
    from tbz.parallel import shard
    from tbz.parallel.mesh import make_mesh
    assert len(jax.devices()) == 8
    mesh = make_mesh(sp=1)
    streams = [corpus(50 + i, 20000 + 777 * i) for i in range(19)]
    payloads = [_gzip.compress(s, 6) for s in streams]
    outs = shard.decode_streams_sharded(payloads, mesh, format="gzip")
    assert outs == streams  # stream order preserved, checksums verified
