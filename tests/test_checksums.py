"""Checksum property tests: device kernels and combine algebra vs zlib
(the strategy the reference applies to its adler/crc variants,
checksums.lisp — here zlib.adler32/zlib.crc32 are the oracle)."""

import os
import zlib

import numpy as np
import pytest

from tbz import checksums as cs

import jax.numpy as jnp


def _pad_len(n, m):
    return max(m, ((n + m - 1) // m) * m)


DATASETS = [
    b"",
    b"a",
    b"hello world",
    bytes(range(256)) * 17,
    os.urandom(4097),
    os.urandom(65536),
    b"\x00" * 10000,
    os.urandom(3) ,
]


def test_crc32_combine_host():
    for a, b in [(b"hello ", b"world"), (b"", b"x"), (b"x", b""),
                 (os.urandom(1000), os.urandom(3000))]:
        want = zlib.crc32(a + b)
        got = cs.crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b))
        assert got == want


def test_adler32_combine_host():
    for a, b in [(b"hello ", b"world"), (b"", b"x"), (b"x", b""),
                 (os.urandom(1000), os.urandom(70000))]:
        want = zlib.adler32(a + b)
        got = cs.adler32_combine(zlib.adler32(a), zlib.adler32(b), len(b))
        assert got == want


@pytest.mark.parametrize("i", range(len(DATASETS)))
def test_adler32_device(i):
    data = DATASETS[i]
    arr = np.frombuffer(data, dtype=np.uint8)
    N = _pad_len(len(arr), cs.ADLER_CHUNK)
    padded = cs.pad_front(arr, N)
    got = int(cs.adler32_device(jnp.asarray(padded), len(arr)))
    assert got == zlib.adler32(data), (i, len(data))


def test_adler32_device_streaming():
    data = os.urandom(100000)
    state = 1
    pos = 0
    for size in (1, 4096, 33333, 100000 - 1 - 4096 - 33333):
        piece = data[pos:pos + size]
        pos += size
        arr = np.frombuffer(piece, dtype=np.uint8)
        N = _pad_len(len(arr), cs.ADLER_CHUNK)
        state = int(cs.adler32_device(jnp.asarray(cs.pad_front(arr, N)),
                                      len(arr), state))
    assert state == zlib.adler32(data)


@pytest.mark.parametrize("i", range(len(DATASETS)))
def test_crc32_device(i):
    data = DATASETS[i]
    arr = np.frombuffer(data, dtype=np.uint8)
    N = _pad_len(len(arr), cs.CRC_LANE_BYTES)
    padded = cs.pad_front(arr, N)
    got = int(cs.crc32_device(jnp.asarray(padded), len(arr)))
    assert got == zlib.crc32(data), (i, len(data))


def test_crc32_device_streaming():
    data = os.urandom(50000)
    state = 0
    pos = 0
    for size in (7, 128, 10000, 50000 - 7 - 128 - 10000):
        piece = data[pos:pos + size]
        pos += size
        arr = np.frombuffer(piece, dtype=np.uint8)
        N = _pad_len(len(arr), cs.CRC_LANE_BYTES)
        state = int(cs.crc32_device(jnp.asarray(cs.pad_front(arr, N)),
                                    len(arr), state))
    assert state == zlib.crc32(data)


def test_combine_device():
    a, b = os.urandom(12345), os.urandom(54321)
    got = int(cs.crc32_combine_device(zlib.crc32(a), zlib.crc32(b), len(b)))
    assert got == zlib.crc32(a + b)
    got = int(cs.adler32_combine_device(zlib.adler32(a), zlib.adler32(b),
                                        len(b)))
    assert got == zlib.adler32(a + b)


def test_jit_shape_reuse():
    """One compiled program serves many lengths at the same pad size."""
    N = 1 << 16
    for n in (0, 1, 100, 65535, 65536):
        data = os.urandom(n)
        arr = cs.pad_front(np.frombuffer(data, np.uint8), N)
        assert int(cs.adler32_device(jnp.asarray(arr), n)) == zlib.adler32(data)
        assert int(cs.crc32_device(jnp.asarray(arr), n)) == zlib.crc32(data)


@pytest.mark.parametrize("kind", ["crc32", "adler32"])
def test_tail_kernels_take_unaligned_buffers(kind):
    """A resolver buffer whose length is no multiple of the kernel's
    chunk (the span resolver's small outputs) is zero-padded, not
    refused; bytes past n never count."""
    data = os.urandom(3000)
    buf = jnp.asarray(np.frombuffer(data + b"\x55" * 77, np.uint8))
    if kind == "crc32":
        assert int(cs.crc32_device_tail(buf, len(data))) == zlib.crc32(data)
    else:
        assert int(cs.adler32_device_tail(buf, len(data))) == \
            zlib.adler32(data)
