#!/usr/bin/env python
"""Smoke run of tbz's device decode on NVIDIA GPUs, end to end.

    python chip_smoke.py               # phases A-D on one card
    python chip_smoke.py --four-cards  # sharded decode + checksums, 4 cards

Every input is generated from a seed (bench.make_corpus, a Silesia-like
mix) and compressed with stdlib gzip/zlib; every output is compared
byte for byte with stdlib zlib/gzip. Phases on one card:

  A  200 MB single-member gzip (level 6) through the fused route,
     device-resident with CRC-32/ISIZE checked on the device, then the
     same call fetched to the host.
  B  16 MB zlib (level 9), device-resident with Adler-32 on the device.
  C  span-resolver route: a 48 KiB gzip body, a 4 MB static-Huffman
     (Z_FIXED) raw stream, and a small stream through the device
     tokenizer; the span resolver is timed against pointer doubling.
  D  1,024 BGZF members through decode_streams_sharded on a one-card
     mesh, CRC-checked on the device.

BGZF members hold BGZF_BLOCK bytes each, htslib's block size: 64 KiB
less 256 bytes, so that even a stored (incompressible) block keeps its
total size within the 16-bit BSIZE field of SAM/BAM specification §4.1.

--four-cards runs only decode_streams_sharded of 4,096 BGZF members and
the sequence-sharded CRC-32/Adler-32 of one 256 MiB buffer over a dp=4
mesh. Each phase prints its cold time (compilation included) and warm
time, output bytes, GB/s of output and the device's peak memory. The
last line of stdout is one JSON object naming the device. Any failure
raises: the script exits non-zero and prints no such line.

The phase functions take sizes and devices, so the tests run them at
tiny sizes on the CPU backend; only main() requires a GPU.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import gzip
import json
import os
import struct
import sys
import time
import zlib

SEED = 20260816
BGZF_BLOCK = 0xFF00


def log(*a):
    print(*a, flush=True)


# --- inputs -----------------------------------------------------------------

def corpus(size: int, seed: int = SEED) -> bytes:
    from bench import make_corpus
    return make_corpus(size, seed)


def bgzf_member(data: bytes, level: int = 6) -> bytes:
    """One BGZF block (SAM/BAM specification §4.1): a gzip member whose
    FEXTRA carries the 'BC' subfield with BSIZE = block size - 1."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    body = co.compress(data) + co.flush()
    size = 18 + len(body) + 8
    if size > 1 << 16:
        raise ValueError(f"BGZF block of {size} bytes exceeds 64 KiB")
    hdr = struct.pack("<BBBBIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0, 255, 6,
                      ord("B"), ord("C"), 2, size - 1)
    return hdr + body + struct.pack("<II", zlib.crc32(data),
                                    len(data) & 0xFFFFFFFF)


def bgzf_members(n: int, member_size: int, seed: int = SEED):
    data = corpus(n * member_size, seed)
    pieces = [data[i * member_size:(i + 1) * member_size] for i in range(n)]
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as ex:
        members = list(ex.map(bgzf_member, pieces))
    return pieces, members


# --- measurement helpers ----------------------------------------------------

def _sync(x):
    import jax
    return jax.block_until_ready(x)


def _timed(fn):
    t0 = time.perf_counter()
    r = fn()
    return r, time.perf_counter() - t0


def _peak_bytes(device) -> str:
    stats = device.memory_stats()
    return str(stats["peak_bytes_in_use"]) if stats else "not reported"


def _report(phase: str, device, cold: float, warm: float, nbytes: int,
            extra: str = ""):
    log(f"[{phase}] cold {cold:.6f} s  warm {warm:.6f} s  out {nbytes} B  "
        f"{nbytes / warm / 1e9:.6f} GB/s (warm)  peak_bytes_in_use "
        f"{_peak_bytes(device)}" + (f"  {extra}" if extra else ""))


def _on(arr, platform: str, devices=None):
    """Assert every shard of `arr` sits on a `platform` device (and, when
    `devices` is given, on one of those)."""
    for d in arr.devices():
        assert d.platform == platform, (d, platform)
        assert devices is None or d in devices, (d, devices)
    return arr


@contextlib.contextmanager
def _config(**kw):
    """Run with a tbz Config that has stage timers on; yields the stage
    table (stage name -> StageStats)."""
    from tbz.utils import config as cfgmod
    from tbz.utils import profiling
    old = cfgmod.get_config()
    cfgmod.set_config(cfgmod.Config(profile=True, **kw))
    profiling.metrics.reset()
    try:
        yield profiling.metrics.stages
    finally:
        cfgmod.set_config(old)


@contextlib.contextmanager
def _recording(obj, name: str, calls: list, returns_kernel: bool = False):
    """Record (jitted fn, args, kwargs) of every call to obj.<name>, a
    jitted function the production code looks up at call time, or, with
    returns_kernel, of every call to the jitted functions it returns."""
    orig = getattr(obj, name)

    def record(fn):
        def rec(*a, **k):
            calls.append((fn, a, k))
            return fn(*a, **k)
        return rec

    setattr(obj, name, (lambda *a, **k: record(orig(*a, **k)))
            if returns_kernel else record(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _memory_line(fn, args, kwargs) -> str:
    m = fn.lower(*args, **kwargs).compile().memory_analysis()
    if m is None:
        return "not reported"
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes")
    return " ".join(f"{k}={getattr(m, k, None)}" for k in keys)


# --- phases on one device ----------------------------------------------------

def phase_a_fused_gzip(size: int, device, level: int = 6):
    """Large single-member gzip through the fused route."""
    import jax.numpy as jnp
    import numpy as np
    import tbz
    from tbz import checksums as cs
    from tbz.ops import batched as B
    from tbz.ops import fused as FF

    data = corpus(size)
    payload = gzip.compress(data, level, mtime=0)
    want = zlib.decompress(payload, 31)
    assert want == data
    # the fused route addresses bits and output bytes in int32
    assert len(payload) * 8 < 1 << 31 and size < 1 << 31, len(payload)
    log(f"[A] gzip L{level}: {size} B -> {len(payload)} B")

    def resident():
        return _sync(tbz.decompress(payload, "gzip", backend="device",
                                    device_resident=True))

    with _config(backend="device") as stages:
        arr, cold = _timed(resident)
        assert "decode.fused" in stages, dict(stages)
    _on(arr, device.platform, [device])
    arr, warm = _timed(resident)
    assert arr.shape == (size,)
    got = np.asarray(arr).tobytes()
    assert got == want
    crc = int(cs.crc32_device_tail(
        jnp.zeros(-(-size // 4096) * 4096, jnp.uint8).at[:size].set(arr),
        size))
    assert crc == zlib.crc32(want), (hex(crc), hex(zlib.crc32(want)))
    _report("A resident", device, cold, warm, size,
            f"crc32 device {crc:#010x} == zlib")
    out, fetched = _timed(lambda: tbz.decompress(payload, "gzip",
                                                 backend="device"))
    assert out == want
    log(f"[A fetched] warm {fetched:.6f} s  out {len(out)} B  "
        f"{len(out) / fetched / 1e9:.6f} GB/s")

    # the two fused kernels once more, recording their arguments for
    # memory_analysis (gzip.compress(mtime=0) writes a 10-byte header)
    kern_calls, splice_calls = [], []
    with _recording(B, "_batched_kernel", kern_calls), \
            _recording(FF, "_get_kernel", splice_calls, returns_kernel=True):
        r = FF.decode_stream_fused(payload[10:], fetch=False,
                                   collect_stats=True)
    assert r is not None
    _, _, total, _, st = r
    assert total == size
    log(f"[A stats] {json.dumps(st, sort_keys=True)}")
    for name, (fn, a, k) in (("_batched_kernel", kern_calls[-1]),
                             ("_splice_resolve", splice_calls[-1])):
        t = _time_warm(lambda: _sync(fn(*a, **k)))
        log(f"[A kernel] {name}: warm {t:.6f} s  memory "
            f"{_memory_line(fn, a, k)}")
    return cold, warm


def phase_b_zlib_adler(size: int, device, level: int = 9):
    """zlib stream decoded device-resident, Adler-32 on the device."""
    import numpy as np
    import tbz

    data = corpus(size, SEED + 1)
    payload = zlib.compress(data, level)
    want = zlib.decompress(payload)
    log(f"[B] zlib L{level}: {size} B -> {len(payload)} B")

    def resident():
        return _sync(tbz.decompress(payload, "zlib", backend="device",
                                    device_resident=True))

    with _config(backend="device") as stages:
        arr, cold = _timed(resident)
        assert "verify.adler32.device" in stages, dict(stages)
    _on(arr, device.platform, [device])
    arr, warm = _timed(resident)
    assert np.asarray(arr).tobytes() == want
    _report("B resident", device, cold, warm, size,
            f"adler32 {zlib.adler32(want):#010x} checked on device")
    return cold, warm


def _time_warm(fn, reps: int = 3) -> float:
    fn()
    return min(_timed(fn)[1] for _ in range(reps))


def phase_c_span_resolver(gzip_size: int, fixed_size: int, device_size: int,
                          device):
    """Streams the fused route does not take: span resolver route."""
    import numpy as np
    import tbz
    from tbz import frontend
    from tbz.ops import resolve as R
    from tbz.ops import resolve_spans as RS

    data = corpus(max(gzip_size, fixed_size, device_size), SEED + 2)
    co = zlib.compressobj(6, zlib.DEFLATED, -15, 8, zlib.Z_FIXED)
    streams = [("gzip", gzip.compress(data[:gzip_size], 6, mtime=0),
                "auto"),
               ("raw", co.compress(data[:fixed_size]) + co.flush(), "auto"),
               ("zlib", zlib.compress(data[:device_size], 9), "device")]
    results = []
    for fmt, payload, fe in streams:
        want = zlib.decompress(payload, {"gzip": 31, "raw": -15,
                                         "zlib": 15}[fmt])
        name = f"C {fmt} {len(want)} B frontend={fe}"

        def resident():
            return _sync(tbz.decompress(payload, fmt, backend="device",
                                        device_resident=True))

        with _config(backend="device", frontend=fe) as stages:
            arr, cold = _timed(resident)
            assert "resolve.spans" in stages, dict(stages)
            _on(arr, device.platform, [device])
            arr, warm = _timed(resident)
            assert np.asarray(arr).tobytes() == want
            out = tbz.decompress(payload, fmt, backend="device")
            assert out == want
        _report(name, device, cold, warm, len(want))
        results.append((cold, warm))

    # span resolver vs pointer doubling on the same tapes (host planning
    # and transfers included: each is timed as the route runs it)
    for fmt, payload, _ in streams[:2]:
        body = payload[10:] if fmt == "gzip" else payload
        want = zlib.decompress(payload, 31 if fmt == "gzip" else -15)
        tape = frontend.tokenize(body).tape

        def spans():
            rows, total = RS.resolve_flat_device(tape, body)
            return _sync(rows), total

        def doubling():
            out, total = R.resolve_device(tape, body)
            return _sync(out), total

        rows, total = spans()
        got = np.asarray(rows).view(np.uint8).reshape(-1)[:total]
        assert got.tobytes() == want
        out, total = doubling()
        assert np.asarray(out[R.W:R.W + total]).tobytes() == want
        t_s, t_d = _time_warm(spans), _time_warm(doubling)
        log(f"[C resolvers] {fmt} {len(want)} B, {len(tape)} tokens: "
            f"span resolver {t_s:.6f} s, pointer doubling {t_d:.6f} s")
    return results


def phase_d_sharded(n_members: int, member_size: int, devices):
    """BGZF members through decode_streams_sharded on a dp mesh over
    `devices`."""
    import numpy as np
    from jax.sharding import Mesh
    from tbz.parallel import shard

    pieces, members = bgzf_members(n_members, member_size, SEED + 3)
    for p, m in zip(pieces[:4], members[:4]):
        assert gzip.decompress(m) == p
    mesh = Mesh(np.array(devices).reshape(len(devices), 1), ("dp", "sp"))
    total = sum(len(p) for p in pieces)
    tag = f"D sharded x{len(devices)}"
    log(f"[{tag}] {n_members} BGZF members: {total} B -> "
        f"{sum(len(m) for m in members)} B")

    def run():
        return shard.decode_streams_sharded(members, mesh, format="gzip",
                                            verify=True)

    outs, cold = _timed(run)
    assert outs == pieces
    outs, warm = _timed(run)
    assert outs == pieces
    res = shard.decode_streams_sharded(members, mesh, format="gzip",
                                       verify=True, device_resident=True)
    seen = set()
    for stream in res:  # one BGZF member per stream: [(array, length)]
        arr = stream[0][0]
        _on(arr, devices[0].platform, devices)
        seen.update(arr.devices())
    assert len(seen) == len(devices), (seen, devices)
    assert np.asarray(res[-1][0][0])[:len(pieces[-1])].tobytes() \
        == pieces[-1]
    _report(tag, devices[0], cold, warm, total,
            f"members on {len(seen)} device(s)")
    return cold, warm


def phase_sharded_checksums(n_bytes: int, devices, seed: int = SEED + 4):
    """Sequence-sharded CRC-32 and Adler-32 of one buffer split over a
    dp mesh, against zlib."""
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from tbz.parallel import shard

    ndev = len(devices)
    mesh = Mesh(np.array(devices).reshape(ndev, 1), ("dp", "sp"))
    buf = np.frombuffer(corpus(n_bytes, seed), np.uint8)
    want_crc, want_adler = zlib.crc32(buf), zlib.adler32(buf)
    x = jax.device_put(buf, NamedSharding(mesh, P("dp")))
    shard_devs = {s.device for s in x.addressable_shards}
    assert len(shard_devs) == ndev, shard_devs
    for d in shard_devs:
        assert d.platform == devices[0].platform
    crc_fn = shard.make_sharded_crc32(mesh, n_bytes)
    adler_fn = shard.make_sharded_adler32(mesh, n_bytes)
    n = np.uint32(n_bytes)
    (crc, adler), cold = _timed(lambda: _sync((crc_fn(x, n),
                                              adler_fn(x, n))))
    assert int(crc) == want_crc and int(adler) == want_adler
    (crc, adler), warm = _timed(lambda: _sync((crc_fn(x, n),
                                              adler_fn(x, n))))
    assert int(crc) == want_crc and int(adler) == want_adler
    _report(f"sharded checksums x{ndev}", devices[0], cold, warm, n_bytes,
            f"crc32 {int(crc):#010x} adler32 {int(adler):#010x} == zlib "
            f"on {ndev} devices")
    return cold, warm


# --- entry point -------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path over four cards")
    args = ap.parse_args(argv)

    # a missing CUDA plugin must fail here, not land on the CPU
    os.environ["JAX_PLATFORMS"] = "cuda"
    from bench import card_line
    cards = card_line()
    import jax
    from tbz.native import loader
    from tbz.utils import compile_cache

    cache = compile_cache.enable()
    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX reports {devices}")
    if not loader.available():
        raise SystemExit("native library failed to build or load")
    log(cards)
    log(f"jax {jax.__version__}  device_kind {dev.device_kind}  "
        f"devices {len(devices)}  compile cache {cache} "
        f"({len(os.listdir(cache)) if os.path.isdir(cache) else 0} "
        f"entries at start)")

    if args.four_cards:
        if len(devices) < 4:
            raise SystemExit(f"--four-cards needs 4 GPUs, found "
                             f"{len(devices)}")
        phase_d_sharded(4096, BGZF_BLOCK, devices[:4])
        phase_sharded_checksums(256 << 20, devices[:4])
    else:
        t0 = time.perf_counter()
        for phase in (lambda: phase_a_fused_gzip(200_000_000, dev),
                      lambda: phase_b_zlib_adler(16_000_000, dev),
                      lambda: phase_c_span_resolver(48 << 10, 4_000_000,
                                                    8 << 10, dev),
                      lambda: phase_d_sharded(1024, BGZF_BLOCK, [dev])):
            phase()
            log(f"[elapsed] {time.perf_counter() - t0:.3f} s")

    log(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
