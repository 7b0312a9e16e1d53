"""Multi-device tests on the 8-virtual-device CPU mesh (the SURVEY §4
distributed-testing stand-in): member-parallel sharded decode and
sequence-sharded checksum combines."""

import gzip as _gzip
import zlib

import numpy as np
import pytest

import jax

from tbz import checksums as cs
from tbz.parallel import shard
from tbz.parallel.mesh import make_mesh

from util import corpus


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, jax.devices()
    return make_mesh(sp=1)


def test_member_parallel_gzip(mesh):
    streams = [corpus(i, 10000 + 3000 * i) for i in range(11)]
    payloads = [_gzip.compress(s, 9) for s in streams]
    outs = shard.decode_streams_sharded(payloads, mesh, format="gzip")
    assert outs == streams


def test_member_parallel_mixed_formats(mesh):
    streams = [corpus(i + 20, 5000 + i * 777) for i in range(5)]
    payloads = [
        _gzip.compress(streams[0], 6),
        zlib.compress(streams[1], 9),
        _gzip.compress(streams[2], 1),
        zlib.compress(streams[3], 0),
        _gzip.compress(streams[4], 9),
    ]
    outs = shard.decode_streams_sharded(payloads, mesh, format="auto")
    assert outs == streams


def test_member_parallel_checksum_detects_corruption(mesh):
    streams = [corpus(i, 20000) for i in range(3)]
    payloads = [bytearray(_gzip.compress(s)) for s in streams]
    payloads[1][-6] ^= 0xFF  # corrupt CRC of member 1
    from tbz.errors import ChecksumError
    with pytest.raises(ChecksumError):
        shard.decode_streams_sharded([bytes(p) for p in payloads], mesh,
                                     format="gzip")


def test_sharded_crc32(mesh):
    N = 8 * 4096
    fn = shard.make_sharded_crc32(mesh, N)
    for n in (0, 1, 5000, N - 1, N):
        data = corpus(n % 7, n)
        arr = np.zeros(N, np.uint8)
        arr[:n] = np.frombuffer(data, np.uint8)
        got = int(fn(arr, np.uint32(n)))
        assert got == zlib.crc32(data), n


def test_sharded_adler32(mesh):
    N = 8 * 8192
    fn = shard.make_sharded_adler32(mesh, N)
    for n in (0, 1, 5000, 40000, N):
        data = corpus(n % 5 + 1, n)
        arr = np.zeros(N, np.uint8)
        arr[:n] = np.frombuffer(data, np.uint8)
        got = int(fn(arr, np.uint32(n)))
        assert got == zlib.adler32(data), n


def test_sharded_crc_odd_lane_count(mesh):
    """Non-pow2 lanes per shard exercises the front-pad identity path."""
    N = 8 * 128 * 3  # 3 lanes/shard
    fn = shard.make_sharded_crc32(mesh, N)
    data = corpus(2, N)
    got = int(fn(np.frombuffer(data, np.uint8), np.uint32(N)))
    assert got == zlib.crc32(data)


def test_single_device_mesh_paths():
    """Same code on a 1-device mesh (the real-chip bench configuration)."""
    m = make_mesh(n_devices=1, sp=1)
    data = corpus(3, 30000)
    payloads = [zlib.compress(data, 9)]
    assert shard.decode_streams_sharded(payloads, m) == [data]
    N = 8192
    fn = shard.make_sharded_crc32(m, N)
    arr = np.zeros(N, np.uint8)
    arr[:3000] = np.frombuffer(data[:3000], np.uint8)
    assert int(fn(arr, np.uint32(3000))) == zlib.crc32(data[:3000])


def test_assign_members_balanced():
    from tbz.parallel.distributed import assign_members
    sizes = [100, 1, 99, 50, 50, 2]
    groups = assign_members(sizes, 3)
    loads = sorted(sum(sizes[i] for i in g) for g in groups)
    assert loads[-1] - loads[0] <= 100  # LPT bound
    assert sorted(i for g in groups for i in g) == list(range(6))


def test_sharded_size_buckets_and_multimember():
    import random
    """19 members spanning 4KB..2MB decode without max-padding blowup
    (pow2 size buckets), including multi-member gzip payloads."""
    import gzip as _gzip
    from tbz.parallel import shard
    from tbz.parallel.mesh import make_mesh
    mesh = make_mesh(sp=1)
    rng = random.Random(5)
    streams = []
    payloads = []
    for i in range(17):
        n = rng.choice([4096, 20000, 100000, 1 << 21])
        s = corpus(i, n)
        streams.append(s)
        payloads.append(zlib.compress(s, 6) if i % 2 else
                        _gzip.compress(s, 6))
    # two multi-member gzip payloads
    for i in (17, 18):
        parts = [corpus(i * 10 + j, 30000) for j in range(3)]
        streams.append(b"".join(parts))
        payloads.append(b"".join(_gzip.compress(p, 6) for p in parts))
    outs = shard.decode_streams_sharded(payloads, mesh)
    assert outs == streams


def test_sharded_per_stream_errors():
    """One corrupt member reports its error value; the others decode
    (SURVEY §5.3: per-stream error values, not batch aborts)."""
    import gzip as _gzip
    import pytest
    from tbz.errors import ChecksumError, DeflateError
    from tbz.parallel import shard
    from tbz.parallel.mesh import make_mesh
    mesh = make_mesh(sp=1)
    streams = [corpus(40 + i, 50000) for i in range(5)]
    payloads = [_gzip.compress(s, 6) for s in streams]
    bad = bytearray(payloads[2])
    bad[len(bad) // 2] ^= 0xFF  # corrupt mid-body
    payloads[2] = bytes(bad)
    outs = shard.decode_streams_sharded(payloads, mesh,
                                        return_errors=True)
    for i, o in enumerate(outs):
        if i == 2:
            assert isinstance(o, DeflateError)
        else:
            assert o == streams[i]
    with pytest.raises(DeflateError):
        shard.decode_streams_sharded(payloads, mesh)


def test_shard_device_error_propagates(mesh, monkeypatch):
    """A device exception is not hidden behind a host re-decode: it
    leaves decode_streams_sharded as raised, even with return_errors
    (which only collects per-stream data errors)."""
    payloads = [_gzip.compress(corpus(60 + i, 30000), 6) for i in range(4)]

    class DeviceFailure(RuntimeError):
        pass

    def boom(*a, **k):
        raise DeviceFailure("injected device failure")

    monkeypatch.setattr(shard, "_resolve_batch", boom)
    with pytest.raises(DeviceFailure):
        shard.decode_streams_sharded(payloads, mesh, format="gzip",
                                     return_errors=True)


def test_trailing_garbage_policy_agrees_across_surfaces(mesh):
    """ONE policy on every surface (round 5): bytes after a complete
    member that don't start another member are benign trailing garbage
    (zlib.decompressobj semantics), for both zlib and gzip framing —
    shard batch decode, one-shot api.decompress, and the streaming
    Decompressor all return the payload's data."""
    import gzip as _g
    from tbz import api
    from tbz.streaming import Decompressor
    data = corpus(70, 20000)
    for fmt, good in (("zlib", zlib.compress(data, 6)),
                      ("gzip", _g.compress(data, 6))):
        junky = good + b"junk!"
        outs = shard.decode_streams_sharded([good, junky], mesh,
                                            format=fmt,
                                            return_errors=True)
        assert outs == [data, data], fmt
        out, info = api.decompress(junky, fmt, with_info=True)
        assert out == data and info.unused_data == b"junk!", fmt
        d = Decompressor(fmt)
        assert d.decompress(junky) == data, fmt
        assert d.unused_data == b"junk!", fmt


def test_shard_device_resident_outputs(mesh):
    """device_resident=True returns (sharded device array, length)
    members and fetches no body bytes (the real-slice template: decoded
    tensors feed device compute; only checksums cross to host)."""
    import numpy as np
    streams = [corpus(80 + i, 30000 + 997 * i) for i in range(4)]
    payloads = [zlib.compress(s, 6) for s in streams]
    outs = shard.decode_streams_sharded(payloads, mesh, format="zlib",
                                        device_resident=True)
    for want, members in zip(streams, outs):
        assert len(members) == 1
        arr, n = members[0]
        assert n == len(want)
        assert hasattr(arr, "devices")  # still a jax array
        assert bytes(np.asarray(arr[:n])) == want


def test_host_decompress_many():
    """Public host-parallel decode (parallel.host.decompress_many):
    mixed formats, caller buffers, per-stream error values."""
    import numpy as np
    import zlib as _z
    from tbz.parallel import host as H
    pieces = [corpus(90 + i, 40000 + i * 1000) for i in range(7)]
    # bytes-out across formats (per-stream auto-detect)
    payloads = [_z.compress(p, 6) if i % 2 else
                _z.compress(p, 9)[2:-4] for i, p in enumerate(pieces)]
    fmts = ["zlib" if i % 2 else "raw" for i in range(7)]
    outs = [H.decompress_many([pl], f)[0]
            for pl, f in zip(payloads, fmts)]
    assert outs == pieces
    zl = [_z.compress(p, 6) for p in pieces]
    assert H.decompress_many(zl, "auto") == pieces
    # caller buffers (known-size contract)
    bufs = [np.empty(len(p) + 64, np.uint8) for p in pieces]
    rs = H.decompress_many(zl, "zlib", out=bufs, threads=3)
    assert [b[:n].tobytes() for b, n in rs] == pieces
    # per-stream error values
    bad = list(zl)
    bad[3] = bad[3][:10]
    res = H.decompress_many(bad, "zlib", return_errors=True)
    assert res[0] == pieces[0] and isinstance(res[3], Exception)
    assert res[6] == pieces[6]
    # without return_errors the error propagates
    import pytest as _pt
    from tbz.errors import DeflateError
    with _pt.raises(DeflateError):
        H.decompress_many(bad, "zlib")


def test_host_compress_many():
    import zlib as _z
    from tbz.parallel import host as H
    pieces = [corpus(110 + i, 30000 + i * 500) for i in range(5)]
    blobs = H.compress_many(pieces, "zlib", 6, threads=3)
    assert [_z.decompress(b) for b in blobs] == pieces
    blobs = H.compress_many(pieces, "raw", 4)
    assert [_z.decompressobj(-15).decompress(b) for b in blobs] == pieces
