"""Batched multi-block device decode (ops/batched): scanner ground
truth, oracle agreement across stream structures, forced junction
fallbacks, and preset-window distance validation."""

import random
import zlib

import numpy as np
import pytest

from tbz import reference
from tbz.errors import DeflateError
from tbz.native import loader
from tbz.ops import batched as BB

from util import corpus, raw_deflate

pytestmark = pytest.mark.skipif(not loader.available(),
                                reason="native scanner required")


def walk_blocks(payload):
    """Sequential ground truth: (hdr_bit, btype, bfinal) per block."""
    from tbz.bitreader import BitReader
    import tbz.constants as C
    br = BitReader(payload, 0)
    out = []
    empty = np.empty(0, np.int32)
    while True:
        p = br.bit_position()
        bfinal = br.bits(1)
        btype = br.bits(2)
        out.append((p, btype, bfinal))
        if btype == C.BTYPE_STORED:
            br.align_to_byte()
            ln = br.bits(16)
            br.bits(16)
            br.read_bytes_aligned(ln)
        else:
            if btype == C.BTYPE_STATIC:
                ll, dl = C.FIXED_LITLEN_LENGTHS, C.FIXED_DIST_LENGTHS
            else:
                lens, hlit, hdist = reference._read_dynamic_lens(br)
                ll, dl = lens[:hlit], lens[hlit:]
            *_, end_bit, _, eob = loader.gap_decode(
                payload, br.bit_position(), ll, dl, empty, 1 << 62,
                cap=1 << 18)
            assert eob
            br = __import__("tbz.bitreader", fromlist=["BitReader"]) \
                .BitReader(payload, end_bit)
        if bfinal:
            return out


def assert_oracle_match(payload, **kw):
    res = BB.tokenize_stream_batched(payload, **kw)
    if isinstance(res, tuple):
        res = res[0]
    ref = reference.tokenize_host(payload, 0)
    assert np.array_equal(res.tape.out_len, ref.tape.out_len)
    assert np.array_equal(res.tape.dist, ref.tape.dist)
    assert np.array_equal(res.tape.root_val, ref.tape.root_val)
    assert res.tape.total_out == ref.tape.total_out
    assert res.end_bit == ref.end_bit
    return res


def test_scanner_finds_all_dynamic_headers():
    for seed, lvl in ((0, 9), (1, 6), (2, 1)):
        payload = raw_deflate(corpus(seed, 160 << 10), lvl)
        truth = [p for (p, bt, _) in walk_blocks(payload) if bt == 2]
        hdr, symb, bfin, hlit, hdist, lens = loader.scan_headers(payload)
        found = set(hdr.tolist())
        assert all(p in found for p in truth), (seed, lvl)
        # candidate lens must round-trip through the host table builder
        # (acceptance parity with the real parse)
        from tbz import huffman
        for i in range(len(hdr)):
            huffman.build_decode_table_checked(
                np.asarray(lens[i, :hlit[i]], np.int64),
                huffman.KIND_LITLEN)


def test_scanner_cap_overflow_retry():
    payload = raw_deflate(corpus(3, 256 << 10), 1)
    full = loader.scan_headers(payload)
    small = loader.scan_headers(payload, cap=1)  # forces overflow retry
    assert np.array_equal(full[0], small[0])


@pytest.mark.parametrize("lvl", [1, 6, 9])
def test_oracle_agreement_levels(lvl):
    data = corpus(10 + lvl, 192 << 10)
    assert_oracle_match(raw_deflate(data, lvl))


def test_multiblock_mixed_types():
    # dynamic + stored + static blocks in one stream
    co = zlib.compressobj(9, zlib.DEFLATED, -15)
    part1 = co.compress(corpus(20, 80 << 10)) + co.flush(zlib.Z_FULL_FLUSH)
    rng = random.Random(21)
    stored = zlib.compressobj(0, zlib.DEFLATED, -15)
    part2 = stored.compress(bytes(rng.randrange(256)
                                  for _ in range(40 << 10)))
    part2 += stored.flush(zlib.Z_FULL_FLUSH)
    fixed = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zlib.Z_FIXED)
    part3 = fixed.compress(corpus(22, 30 << 10)) + fixed.flush()
    payload = part1 + part2 + part3
    blocks = walk_blocks(payload)
    kinds = {bt for (_, bt, _) in blocks}
    assert kinds >= {0, 1, 2}, kinds  # all three block types present
    res, stats = BB.tokenize_stream_batched(payload, collect_stats=True)
    ref = reference.tokenize_host(payload, 0)
    assert np.array_equal(res.tape.out_len, ref.tape.out_len)
    assert np.array_equal(res.tape.dist, ref.tape.dist)
    assert np.array_equal(res.tape.root_val, ref.tape.root_val)
    assert stats["gap_blocks"] > 0  # static blocks go through fallback


def test_forced_junction_joins(monkeypatch):
    """A tiny overlap window forces most junctions through the
    host-join path (gap decode + exact-landing verification)."""
    monkeypatch.setattr(BB, "EXT_BITS", 8)
    data = corpus(30, 160 << 10)
    res = assert_oracle_match(raw_deflate(data, 9), collect_stats=True)


def test_window_distance_validation():
    """window_len admits back-references into a preset window; without
    it the same stream must raise ERR_BAD_DISTANCE (deferred check)."""
    dictionary = corpus(40, 16 << 10)
    co = zlib.compressobj(9, zlib.DEFLATED, -15, 9, zlib.Z_DEFAULT_STRATEGY,
                          dictionary)
    body = corpus(40, 96 << 10)  # shares content with the dictionary
    payload = co.compress(dictionary + body) + co.flush()
    ref = reference.tokenize_host(payload, 0,
                                  window_len=len(dictionary))
    res = BB.tokenize_stream_batched(payload,
                                     window_len=len(dictionary))
    assert np.array_equal(res.tape.out_len, ref.tape.out_len)
    assert np.array_equal(res.tape.dist, ref.tape.dist)
    if int(ref.tape.dist.max(initial=0)) > 0:
        first_needs_window = bool(
            np.any(ref.tape.dist
                   > np.cumsum(ref.tape.out_len) - ref.tape.out_len))
        if first_needs_window:
            with pytest.raises(DeflateError):
                BB.tokenize_stream_batched(payload, window_len=0)


def test_bitflip_fuzz_against_oracle():
    payload = bytearray(raw_deflate(corpus(50, 128 << 10), 9))
    rng = random.Random(77)
    for _ in range(12):
        i = rng.randrange(len(payload))
        b = 1 << rng.randrange(8)
        payload[i] ^= b
        p = bytes(payload)
        try:
            ref = ("ok", reference.tokenize_host(p, 0))
        except DeflateError as e:
            ref = ("err", type(e).__name__ == "TruncatedError")
        try:
            got = ("ok", BB.tokenize_stream_batched(p))
        except DeflateError as e:
            got = ("err", type(e).__name__ == "TruncatedError")
        assert got[0] == ref[0], i
        if ref[0] == "ok":
            assert np.array_equal(got[1].tape.out_len,
                                  ref[1].tape.out_len)
            assert np.array_equal(got[1].tape.dist, ref[1].tape.dist)
            assert np.array_equal(got[1].tape.root_val,
                                  ref[1].tape.root_val)
        else:
            assert got[1] == ref[1], i  # trunc vs err class agreement
        payload[i] ^= b


def test_many_small_blocks():
    """Sync-flush-heavy stream: hundreds of tiny dynamic blocks means
    hundreds of candidates/segments (table-batch and lane-plan shapes
    well past the common case)."""
    co = zlib.compressobj(9, zlib.DEFLATED, -15)
    parts = []
    for i in range(300):
        parts.append(co.compress(corpus(100 + i, 700)))
        parts.append(co.flush(zlib.Z_SYNC_FLUSH))
    parts.append(co.flush())
    payload = b"".join(parts)
    assert_oracle_match(payload)


def test_bounded_fetch_invariant():
    """The batched decode's defining property: the whole stream comes
    back in at most TWO D2H fetches (meta + token prefix in one, an
    optional tail), regardless of block count: each extra fetch is a
    device-to-host round trip."""
    co = zlib.compressobj(9, zlib.DEFLATED, -15)
    parts = []
    for i in range(24):  # many dynamic blocks via full flushes
        parts.append(co.compress(corpus(40 + i, 48 << 10)))
        parts.append(co.flush(zlib.Z_FULL_FLUSH))
    payload = b"".join(parts) + co.flush()
    assert len(walk_blocks(payload)) >= 24
    res, stats = BB.tokenize_stream_batched(payload, collect_stats=True)
    ref = reference.tokenize_host(payload, 0)
    assert np.array_equal(res.tape.out_len, ref.tape.out_len)
    assert stats["fetches"] <= 2
