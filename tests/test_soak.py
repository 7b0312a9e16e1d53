"""Reference-scale soak tests (opt-in: `pytest -m slow`).

Ports of the reference's heavyweight harnesses at their ORIGINAL scale:
  - 30,000-iteration random input chunk-split fuzz
    (test-chunked-input.lisp:54-75),
  - 30,000-iteration random output harvest-size fuzz
    (test-chunked-output.lisp:68-89),
  - ~100MB mixed-corpus round trip through zlib AND gzip framing,
    cross-checked against stdlib (zlib-test.lisp / gzip-test.lisp:4-41).
CI runs scaled-down versions of all three (tests/test_streaming.py,
tests/test_baseline_configs.py); these are the full-scale gates.
"""

import gzip as _gzip
import random
import zlib

import pytest

from tbz import api
from tbz.streaming import Decompressor

from util import corpus, fixture

pytestmark = pytest.mark.slow


def _fixture_payload():
    """The in-repo fixture (tests/data/fixture.deflated): size header
    + raw level-9 deflate, the shape of the reference's own fixture
    (test-chunked-input.lisp:8-25)."""
    size, payload = fixture()
    want = zlib.decompressobj(-15).decompress(payload)
    assert len(want) == size
    return payload, want


def test_soak_30k_random_input_chunks():
    payload, want = _fixture_payload()
    rng = random.Random(20260817)
    for it in range(30000):
        d = Decompressor("raw")
        out = []
        pos = 0
        while pos < len(payload):
            n = rng.randint(1, 1234)
            out.append(d.decompress(payload[pos:pos + n]))
            pos += n
        out.append(d.flush())
        assert b"".join(out) == want, f"iteration {it}"


def test_soak_30k_random_output_buffers():
    payload, want = _fixture_payload()
    rng = random.Random(42424242)
    for it in range(30000):
        d = Decompressor("raw")
        out = [d.decompress(payload, max_length=rng.randint(1, 12345))]
        stall = 0
        while not d.eof and stall < 4:
            piece = d.decompress(b"", max_length=rng.randint(1, 12345))
            out.append(piece)
            stall = stall + 1 if not piece else 0
        out.append(d.flush())
        assert b"".join(out) == want, f"iteration {it}"


def _big_corpus(size=96 * 1000 * 1000):
    import importlib.util as iu
    import os
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = iu.spec_from_file_location("bench", os.path.join(here, "bench.py"))
    bench = iu.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench.make_corpus(size)


def test_large_corpus_zlib_gzip_three_frontends():
    """~96MB through both framings; native one-shot and streaming paths
    byte-exact vs stdlib; python-oracle and device frontends cross-check
    slices (their full-corpus rates are CI-hostile by design)."""
    data = _big_corpus()

    # zlib framing, one-shot native
    zpayload = zlib.compress(data, 6)
    assert api.decompress(zpayload, "zlib") == data

    # gzip framing, multi-member, streaming path in 1MB chunks
    members = [data[i:i + 12 * 1000 * 1000]
               for i in range(0, len(data), 12 * 1000 * 1000)]
    gpayload = b"".join(_gzip.compress(m, 6) for m in members)
    assert _gzip.decompress(gpayload) == data  # stdlib agrees on input
    d = Decompressor("gzip")
    out = []
    for i in range(0, len(gpayload), 1 << 20):
        out.append(d.decompress(gpayload[i:i + (1 << 20)]))
    out.append(d.flush())
    assert b"".join(out) == data
    assert len(d.members) == len(members)

    # our encoder's output decoded by stdlib AND by us, full size
    ours = api.compress(data, "gzip", 6)
    assert len(ours) <= len(gpayload)
    assert _gzip.decompress(ours) == data
    assert api.decompress(ours, "gzip") == data

    # python oracle frontend: 8MB slice (bit-exact contract with native
    # is separately fuzz-checked in test_three_way.py)
    from tbz import reference
    sl = data[:8 * 1000 * 1000]
    spayload = zlib.compress(sl, 9)[2:-4]
    res = reference.tokenize_host(spayload, 0)
    got = reference.resolve_host(res.tape, spayload, b"")
    assert got == sl

    # device frontend + span resolver: 2MB slice
    from tbz import frontend
    from tbz.ops import resolve_spans as rs
    dl = data[:2 * 1000 * 1000]
    dpayload = zlib.compress(dl, 9)[2:-4]
    dres = frontend.tokenize(dpayload, frontend="device")
    assert rs.resolve_flat_bytes(dres.tape, dpayload, b"") == dl
