"""Native runtime (C++) vs Python oracle: tapes must be bit-identical
(the io.lisp:108-128 monomorphic-copies strategy — several frontends, one
contract, cross-checked)."""

import random
import zlib

import numpy as np
import pytest

from tbz import reference
from tbz.errors import DeflateError, TruncatedError
from tbz.native import loader

from util import corpus, fixture, raw_deflate

pytestmark = pytest.mark.skipif(not loader.available(),
                                reason="native build unavailable")


def tapes_equal(a, b):
    return (np.array_equal(a.tape.out_len, b.tape.out_len)
            and np.array_equal(a.tape.dist, b.tape.dist)
            and np.array_equal(a.tape.root_val, b.tape.root_val)
            and a.end_bit == b.end_bit and a.finished == b.finished)


def test_fixture_identical():
    _, payload = fixture()
    assert tapes_equal(loader.tokenize(payload),
                       reference.tokenize_host(payload))
    out, _, fin = loader.inflate(payload)
    assert fin and out == zlib.decompressobj(-15).decompress(payload)


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_tape_identical_all_levels(level):
    data = corpus(55, 1 << 17)
    payload = raw_deflate(data, level)
    assert tapes_equal(loader.tokenize(payload),
                       reference.tokenize_host(payload))
    assert loader.resolve(loader.tokenize(payload).tape, payload) == data


def test_error_parity_bitflips():
    """Native and Python classify corrupted streams identically."""
    rng = random.Random(8)
    data = corpus(9, 1 << 13)
    payload = bytearray(raw_deflate(data, 9))
    for _ in range(200):
        i = rng.randrange(len(payload))
        bit = 1 << rng.randrange(8)
        payload[i] ^= bit
        p = bytes(payload)
        try:
            a = ("ok", reference.inflate_raw(p)[0])
        except TruncatedError:
            a = ("trunc", None)
        except DeflateError as e:
            a = ("err", e.code)
        try:
            b = ("ok", loader.inflate(p)[0])
        except TruncatedError:
            b = ("trunc", None)
        except DeflateError as e:
            b = ("err", e.code)
        assert a == b, (a, b, i)
        payload[i] ^= bit


def test_truncation_parity():
    data = corpus(10, 1 << 12)
    payload = raw_deflate(data, 9)
    for cut in range(0, len(payload), 11):
        p = payload[:cut]
        try:
            a = ("ok", reference.inflate_raw(p)[0])
        except TruncatedError:
            a = ("trunc", None)
        except DeflateError as e:
            a = ("err", e.code)
        try:
            b = ("ok", loader.inflate(p)[0])
        except TruncatedError:
            b = ("trunc", None)
        except DeflateError as e:
            b = ("err", e.code)
        assert a == b


def test_window_resolve():
    hist = corpus(11, 50000)
    co = zlib.compressobj(9, zlib.DEFLATED, -15, zdict=hist)
    payload = co.compress(hist[-500:] * 5) + co.flush()
    res = loader.tokenize(payload, window_len=len(hist))
    got = loader.resolve(res.tape, payload, window=hist[-32768:])
    do = zlib.decompressobj(-15, zdict=hist)
    assert got == do.decompress(payload)


def test_matcher_valid_tokens():
    """Matcher output reconstructs the input and respects DEFLATE limits."""
    for level in (1, 6, 9):
        data = corpus(12, 1 << 16)
        ol, di, li = loader.lz77_match(data, level)
        out = bytearray()
        for l, d, v in zip(ol.tolist(), di.tolist(), li.tolist()):
            if d == 0:
                out.append(v)
            else:
                assert 3 <= l <= 258 and 1 <= d <= 32768
                src = len(out) - d
                assert src >= 0
                for k in range(l):
                    out.append(out[src + k])
        assert bytes(out) == data


def test_overflow_retry_path():
    """Tiny initial cap exercises the tape-overflow retry protocol."""
    import tbz.native.loader as L
    data = corpus(13, 200000)
    payload = raw_deflate(data, 9)
    res = L.tokenize(payload)  # cap heuristic may or may not overflow
    assert L.resolve(res.tape, payload) == data


def test_tail_match_truncation_replay():
    """Streams whose final tokens are matches, truncated at every byte
    near the end: the fast loop's near-exhaustion replay (a token whose
    dist code may be only partially buffered re-runs in the careful
    region) must keep byte and error-class parity with the reference
    frontend."""
    import numpy as np
    rng = np.random.default_rng(9)
    for trial in range(12):
        n = int(rng.integers(500, 5000))
        base = rng.integers(97, 123, n).astype(np.uint8).tobytes()
        data = base + base[-64:] * 8  # forces trailing matches
        payload = zlib.compress(data, 6)[2:-4]
        out, _, _ = loader.inflate(payload, size_hint=len(data))
        assert bytes(out) == data
        for cut in range(max(1, len(payload) - 40), len(payload)):
            p = payload[:cut]
            try:
                a = ("ok", bytes(loader.inflate(p)[0]))
            except TruncatedError:
                a = ("trunc", None)
            except DeflateError as e:
                a = ("err", e.code)
            try:
                o, _, done = reference.inflate_raw(p)
                b = ("ok", bytes(o)) if done else ("trunc", None)
            except TruncatedError:
                b = ("trunc", None)
            except DeflateError as e:
                b = ("err", e.code)
            assert a == b, (trial, cut, a[0], b[0])


def test_inflate_pair_matches_single():
    """tbz_inflate_pair (two streams, one interleaved loop) must be
    bit-exact with the single-stream path across content kinds, levels,
    and sizes — including empty inputs and stored blocks."""
    import numpy as np
    rng = np.random.default_rng(3)

    def mk(kind, n):
        if kind == 0:
            return rng.integers(32, 127, n).astype(np.uint8).tobytes()
        if kind == 1:
            return rng.integers(0, 256, n).astype(np.uint8).tobytes()
        if kind == 2:
            page = rng.integers(0, 256, 2048).astype(np.uint8)
            return np.tile(page, max(1, n // 2048)).tobytes()[:n]
        if kind == 3:
            return bytes(n)
        words = [rng.integers(97, 123, size=int(rng.integers(3, 9)))
                 .astype(np.uint8).tobytes() for _ in range(200)]
        return b' '.join(
            words[int(i)] for i in rng.integers(0, 200, max(1, n // 6)))[:n]

    for trial in range(40):
        a = mk(int(rng.integers(0, 5)), int(rng.integers(0, 200000)))
        b = mk(int(rng.integers(0, 5)), int(rng.integers(0, 200000)))
        ca = zlib.compress(a, int(rng.integers(0, 10)))[2:-4]
        cb = zlib.compress(b, int(rng.integers(0, 10)))[2:-4]
        ra, rb = loader.inflate_pair(ca, cb, len(a), len(b))
        assert ra == a and rb == b, trial


def test_inflate_pair_error_parity():
    """Corrupt / truncated / undersized-hint inputs through inflate_pair
    must produce exactly the single path's outcome (the pair kernel
    bails on any anomaly and the wrapper re-decodes singly)."""
    import numpy as np
    rng = np.random.default_rng(17)
    good_data = b"x" * 1000
    good = zlib.compress(good_data, 6)[2:-4]
    for trial in range(60):
        n = int(rng.integers(100, 40000))
        data = rng.integers(32, 127, n).astype(np.uint8).tobytes()
        comp = bytearray(zlib.compress(data, int(rng.integers(1, 10)))[2:-4])
        if trial % 3 == 0:
            comp[int(rng.integers(0, len(comp)))] ^= 1 << int(rng.integers(0, 8))
        elif trial % 3 == 1:
            comp = comp[:int(rng.integers(1, len(comp)))]
        comp = bytes(comp)
        try:
            s = ('ok', loader.inflate(comp, size_hint=n)[0])
        except TruncatedError:
            s = ('trunc', None)
        except DeflateError:
            s = ('err', None)
        try:
            pa, pb = loader.inflate_pair(comp, good, n, len(good_data))
            p = ('ok', pa)
            assert pb == good_data
        except TruncatedError:
            p = ('trunc', None)
        except DeflateError:
            p = ('err', None)
        assert p == s, (trial, p[0], s[0])
    # undersized hint: silent fallback, right bytes
    data = bytes(np.arange(5000, dtype=np.uint8))
    comp = zlib.compress(data, 6)[2:-4]
    ra, rb = loader.inflate_pair(comp, comp, 10, 5000)
    assert ra == data and rb == data
