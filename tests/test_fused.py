"""Fused device-resident decode (ops/fused): bit-exact output with ZERO
token D2H, host-token splicing (stored/static/gap blocks) through the
device resolver, sequential error ordering, and the public-API
device/device_resident dispatch."""

import random
import zlib

import numpy as np
import pytest

from tbz.errors import DeflateError, TruncatedError
from tbz.native import loader
from tbz.ops import batched as BB
from tbz.ops import fused as FF

from util import corpus, raw_deflate

pytestmark = pytest.mark.skipif(not loader.available(),
                                reason="native scanner required")


def run_fused(payload, window=b"", **kw):
    r = FF.decode_stream_fused(payload, window, collect_stats=True, **kw)
    assert r is not None
    return r


@pytest.mark.parametrize("lvl", [1, 6, 9])
def test_roundtrip_levels_zero_token_d2h(lvl):
    data = corpus(10 + lvl, 192 << 10)
    out, dev, total, end_bit, st = run_fused(raw_deflate(data, lvl))
    assert out == data and total == len(data)
    assert st["token_d2h_bytes"] == 0
    assert st["meta_d2h_bytes"] > 0
    assert bytes(np.asarray(dev[:total])) == data


def test_mixed_block_types_host_tokens_on_device():
    """Stored + static blocks ride the host-token upload path; stored
    runs resolve through the device's input-byte gather."""
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
    data = zlib.decompress(payload, -15)
    out, _, total, _, st = run_fused(payload)
    assert out == data and total == len(data)
    assert st["gap_blocks"] > 0 and st["token_d2h_bytes"] == 0


def test_forced_junction_joins(monkeypatch):
    """A tiny overlap window forces junctions through host gap joins;
    the joined tokens must splice into the device chain bit-exactly."""
    monkeypatch.setattr(BB, "EXT_BITS", 8)
    data = corpus(30, 160 << 10)
    out, _, total, _, st = run_fused(raw_deflate(data, 9))
    assert out == data
    assert st["joins"] > 0


def test_small_stream_direct():
    data = corpus(31, 16 << 10)
    out, _, total, _, _ = run_fused(raw_deflate(data, 9))
    assert out == data


def test_static_only_stream_falls_back():
    """No dynamic-block candidates -> the fused path declines (None)
    and the caller's fallback owns the stream."""
    data = corpus(32, 4 << 10)
    payload = raw_deflate(data, 6)
    from tbz.native import loader as NL
    if len(NL.scan_headers(payload)[0]) == 0:
        assert FF.decode_stream_fused(payload) is None


def test_window_distance_validation():
    """Preset window admits far back-references; without it the device
    distance check must raise ERR_BAD_DISTANCE."""
    dictionary = corpus(40, 16 << 10)
    co = zlib.compressobj(9, zlib.DEFLATED, -15, 9,
                          zlib.Z_DEFAULT_STRATEGY, dictionary)
    body = corpus(40, 96 << 10)
    payload = co.compress(dictionary + body) + co.flush()
    data = dictionary + body
    out, _, total, _, _ = run_fused(payload, window=dictionary)
    assert out == data
    from tbz import reference
    ref = reference.tokenize_host(payload, 0, window_len=len(dictionary))
    needs_window = bool(np.any(
        ref.tape.dist > np.cumsum(ref.tape.out_len) - ref.tape.out_len))
    if needs_window:
        with pytest.raises(DeflateError):
            run_fused(payload)


def test_distance_error_outranks_later_truncation():
    """zlib's sequential order: a bad distance in already-emitted tokens
    raises before a structural/truncation error later in the stream."""
    dictionary = corpus(41, 16 << 10)
    co = zlib.compressobj(9, zlib.DEFLATED, -15, 9,
                          zlib.Z_DEFAULT_STRATEGY, dictionary)
    payload = co.compress(dictionary + corpus(41, 200 << 10)) + co.flush()
    from tbz import reference
    ref = reference.tokenize_host(payload, 0, window_len=len(dictionary))
    if not np.any(ref.tape.dist
                  > np.cumsum(ref.tape.out_len) - ref.tape.out_len):
        pytest.skip("no dictionary back-reference produced")
    cut = payload[:len(payload) * 2 // 3]
    with pytest.raises(DeflateError) as ei:
        run_fused(cut)  # window_len=0: first dict reference is too far
    assert not isinstance(ei.value, TruncatedError)


def test_truncation_class():
    payload = raw_deflate(corpus(50, 128 << 10), 9)
    with pytest.raises(DeflateError):
        run_fused(payload[:len(payload) // 2])


def test_bitflip_fuzz_class_agreement():
    payload = bytearray(raw_deflate(corpus(51, 96 << 10), 9))
    from tbz import reference
    rng = random.Random(7)
    for _ in range(8):
        i = rng.randrange(len(payload))
        b = 1 << rng.randrange(8)
        payload[i] ^= b
        p = bytes(payload)
        try:
            ref = ("ok", reference.tokenize_host(p, 0))
        except DeflateError as e:
            ref = ("err", isinstance(e, TruncatedError))
        try:
            r = FF.decode_stream_fused(p)
            got = ("ok", r)
        except DeflateError as e:
            got = ("err", isinstance(e, TruncatedError))
        assert got[0] == ref[0], i
        if ref[0] == "ok":
            from tbz.reference import resolve_host
            want = resolve_host(ref[1].tape, p)
            assert got[1][0] == want, i
        else:
            assert got[1] == ref[1], i
        payload[i] ^= b


def test_api_device_backend_uses_fused():
    """backend='device' one-shot: output parity and the fused stage in
    the profile (the public-API wiring)."""
    from tbz import api
    from tbz.utils import config as cfgmod
    from tbz.utils import profiling
    data = corpus(60, 768 << 10)
    payload = zlib.compress(data, 6)
    assert len(payload) >= 65536  # over the fused dispatch threshold
    old = cfgmod.get_config()
    try:
        cfgmod.set_config(cfgmod.Config(backend="device", profile=True))
        profiling.metrics.reset()
        out = api.decompress(payload)
        assert out == data
        assert any("decode.fused" in ln
                   for ln in profiling.metrics.report().splitlines())
    finally:
        cfgmod.set_config(old)


def test_api_device_resident_fused():
    from tbz import api
    data = corpus(61, 768 << 10)
    payload = zlib.compress(data, 9)
    assert len(payload) >= 65536
    arr = api.decompress(payload, backend="device", device_resident=True)
    assert bytes(np.asarray(arr)) == data


def test_gzip_multimember_device():
    import gzip as _g
    from tbz import api
    d1, d2 = corpus(62, 768 << 10), corpus(63, 80 << 10)
    payload = _g.compress(d1) + _g.compress(d2)
    out = api.decompress(payload, backend="device")
    assert out == d1 + d2
