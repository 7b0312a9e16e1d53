"""All-device tokenizer vs the Python oracle: identical tapes, identical
error classes (third frontend under the io.lisp-style one-contract rule)."""

import random
import zlib

import numpy as np
import pytest

from tbz import reference
from tbz.errors import DeflateError, TruncatedError
from tbz.ops.tokenize_device import tokenize_device

from util import corpus, fixture, raw_deflate


def tapes_equal(a, b):
    return (np.array_equal(a.tape.out_len, b.tape.out_len)
            and np.array_equal(a.tape.dist, b.tape.dist)
            and np.array_equal(a.tape.root_val, b.tape.root_val)
            and a.end_bit == b.end_bit and a.finished == b.finished)


def classify(fn, payload):
    try:
        return ("ok", fn(payload))
    except TruncatedError:
        return ("trunc", None)
    except DeflateError:
        return ("err", None)


def test_fixture_identical():
    _, payload = fixture()
    assert tapes_equal(tokenize_device(payload),
                       reference.tokenize_host(payload))


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_tape_identity(level):
    payload = raw_deflate(corpus(60, 1 << 14), level)
    assert tapes_equal(tokenize_device(payload),
                       reference.tokenize_host(payload))


def test_resolves_through_device_resolver():
    from tbz.ops import resolve
    data = corpus(61, 1 << 15)
    payload = raw_deflate(data, 9)
    res = tokenize_device(payload)
    assert resolve.resolve_bytes(res.tape, payload) == data


def test_error_class_parity():
    rng = random.Random(5)
    payload = bytearray(raw_deflate(corpus(62, 1 << 11), 9))
    checked = 0
    for _ in range(60):
        i = rng.randrange(len(payload))
        b = 1 << rng.randrange(8)
        payload[i] ^= b
        p = bytes(payload)
        a = classify(tokenize_device, p)[0]
        bcls = classify(reference.tokenize_host, p)[0]
        assert a == bcls, (i, a, bcls)
        checked += 1
        payload[i] ^= b
    assert checked == 60


def test_truncation_parity():
    payload = raw_deflate(corpus(63, 1 << 10), 9)
    for cut in range(0, len(payload), 17):
        a = classify(tokenize_device, payload[:cut])[0]
        b = classify(reference.tokenize_host, payload[:cut])[0]
        assert a == b, cut


def test_frontend_device_dispatch():
    """frontend.tokenize(frontend='device') actually routes to the
    device tokenizer (round-1 review: the option was documented but
    fell through to the python oracle)."""
    import zlib
    from tbz import frontend, reference
    data = b"device dispatch check " * 50
    payload = zlib.compress(data, 9)[2:-4]
    res_dev = frontend.tokenize(payload, frontend="device")
    res_py = reference.tokenize_host(payload, 0)
    assert res_dev.finished and res_dev.end_bit == res_py.end_bit
    assert (res_dev.tape.out_len == res_py.tape.out_len).all()
    assert (res_dev.tape.dist == res_py.tape.dist).all()
    assert (res_dev.tape.root_val == res_py.tape.root_val).all()
    import pytest
    with pytest.raises(ValueError):
        frontend.tokenize(payload, frontend="nonsense")
