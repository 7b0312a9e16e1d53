"""One-shot easy API (the reference's L6, api.lisp:3-73).

`decompress` auto-detects raw/zlib/gzip framing (or takes it explicitly),
runs a frontend tokenizer plus the device resolver, verifies checksums
(device tail kernels or host zlib), and handles multi-member gzip — the
one-shot `decompress-vector` contract including the known-output-size
fast path (api.lisp:36-48), without the grow-and-copy loop (two-phase
decode knows exact sizes up front).
"""

from __future__ import annotations

import contextlib
import dataclasses
import zlib as _zlib

import numpy as np

from . import frontend as _frontend
from .errors import DeflateError, TruncatedError, ERR_HEADER
from .formats import gzip_fmt, zlib_fmt
from .utils.config import get_config


def _stage(name: str, nbytes: int = 0):
    """Stage timer (populates utils.profiling.metrics when
    Config.profile / TBZ_PROFILE=1 is set; no-op otherwise)."""
    if get_config().profile:
        from .utils import profiling
        return profiling.metrics.stage(name, nbytes)
    return contextlib.nullcontext()

# Backend policy: 'auto' resolves on the host (native C++ when built) and
# verifies checksums host-side; 'device' decodes streams >= 64KB through
# the fused route (ops/fused), others through a frontend tokenizer and
# the span resolver (ops/resolve_spans), and can verify checksums
# (bit-matrix CRC / chunked Adler) on the accelerator. 'auto' stays on
# the host until a GPU measurement shows the device path ahead.


@dataclasses.dataclass
class MemberInfo:
    format: str                      # 'raw' | 'zlib' | 'gzip'
    header: object | None            # ZlibHeader / GzipHeader / None
    output_size: int
    consumed: int                    # input bytes consumed incl. trailer


@dataclasses.dataclass
class StreamInfo:
    format: str
    members: list
    consumed: int                    # total input bytes consumed
    unused_data: bytes               # trailing bytes past the stream


def detect_format(data: bytes) -> str:
    if len(data) >= 2 and data[0] == 0x1F and data[1] == 0x8B:
        return "gzip"
    if (len(data) >= 2 and (data[0] & 0x0F) == 8 and (data[0] >> 4) <= 7
            and ((data[0] << 8) | data[1]) % 31 == 0):
        return "zlib"
    return "raw"


def _decode_body(body: bytes, window: bytes, backend: str,
                 size_hint: int = 0, fetch: bool = True):
    """One member's deflate body ->
    (out_bytes_or_None, total, end_bit, finished, body_dev).

    Host path uses the fused single-pass native inflate; device path
    tokenizes then resolves on the accelerator. fetch=False keeps the
    resolved output device-resident (out is None; body_dev holds it) —
    the donated-buffer/on-mesh consumer path. Raises TruncatedError on
    underrun (one-shot semantics)."""
    if backend in ("host", "auto"):
        try:
            from .native import loader
            if loader.available():
                with _stage("inflate.host", len(body)):
                    out, end_bit, fin = loader.inflate(
                        body, window=window, size_hint=size_hint)
                return out, len(out), end_bit, fin, None
        except ImportError:
            pass
        from . import reference
        res = reference.tokenize_host(body, 0, window_len=len(window))
        out = reference.resolve_host(res.tape, body, window)
        return out, len(out), res.end_bit, res.finished, None
    if get_config().frontend in ("auto", "device") and len(body) >= 65536:
        # fused device-resident pipeline: batched tokenize -> on-device
        # splice -> pointer-doubling resolve; only metadata crosses D2H
        # (ops/fused). Falls through when the native scanner is missing
        # or the stream has no dynamic-block candidates.
        from .ops import fused as _fused
        with _stage("decode.fused", len(body)):
            r = _fused.decode_stream_fused(body, window, fetch=fetch)
        if r is not None:
            out, dev_body, total, end_bit = r
            return out, int(total), end_bit, True, dev_body
    with _stage("tokenize", len(body)):
        res = _frontend.tokenize(body, 0, window_len=len(window),
                                 frontend=get_config().frontend)
    with _stage("resolve.device", res.tape.total_out):
        try:
            from .native import loader as _nl
            native_ok = _nl.available()
        except ImportError:
            native_ok = False
        use_spans = native_ok
        if use_spans:
            try:
                # flat span resolver: global row gathers, segment-local
                # scatters (ops/resolve_spans, round-3 fast path)
                import jax as _jax
                import jax.numpy as _jnp
                from .ops import resolve_spans as _rs
                with _stage("resolve.spans", res.tape.total_out):
                    rows, total = _rs.resolve_flat_device(res.tape, body,
                                                          window)
                dev_body = _jax.lax.bitcast_convert_type(
                    rows, _jnp.uint8).reshape(-1)
            except ValueError:
                # >2GB stream: int32 table addresses can't span it
                use_spans = False
            except DeflateError as e:
                if e.code != 12:  # ERR_PLAN_DEPTH: pathological genealogy
                    raise
                use_spans = False
        if not use_spans:
            # fallback: pointer-doubling resolver (needs no native planner)
            from .ops import resolve as _r
            out_dev, total = _r.resolve_device(res.tape, body, window)
            dev_body = out_dev[_r.W:]
    out = bytes(np.asarray(dev_body[:total])) if fetch else None
    return out, int(total), res.end_bit, res.finished, dev_body


def _verify_device(kind: str, body_dev, total: int, prev: int) -> int:
    """Device-resident checksum (only the scalar crosses to host)."""
    from . import checksums as cs
    with _stage(f"verify.{kind}.device", total):
        if kind == "crc32":
            return int(cs.crc32_device_tail(body_dev, total, prev))
        return int(cs.adler32_device_tail(body_dev, total, prev))


def _verify_device_or_host(kind: str, body_dev, out: bytes, prev: int):
    """Checksum for one-shot decompress. The one-shot path has ALWAYS
    already fetched `out` to the host, so host zlib needs no device
    round trip here. The device kernels are the verification path where
    output stays device-resident (parallel/shard.py, checksums tests);
    Config.device_checksums=1 forces them here for pipeline testing
    through the public API."""
    with _stage(f"verify.{kind}", len(out)):
        if body_dev is not None and get_config().device_checksums:
            from . import checksums as cs
            if kind == "crc32":
                return int(cs.crc32_device_tail(body_dev, len(out), prev))
            return int(cs.adler32_device_tail(body_dev, len(out), prev))
        if kind == "crc32":
            return _zlib.crc32(out, prev)
        return _zlib.adler32(out, prev)


def decompress(data, format: str = "auto", *, backend: str | None = None,
               zdict: bytes = b"", verify: bool = True,
               output_size: int | None = None,
               multi_member: bool = True, with_info: bool = False,
               device_resident: bool = False):
    """Decompress a raw deflate / zlib / gzip byte stream.

    backend: 'auto' | 'device' | 'host' — where LZ77 resolution and
    checksum verification run (None reads Config.backend / TBZ_BACKEND).
    output_size: known-size fast path hint (api.lisp:36-48 contract) —
    the output buffer is sized exactly.
    device_resident: return the output as a device-resident uint8
    jax.Array instead of host bytes — nothing but checksum scalars
    crosses device->host (the on-mesh-consumer form of the known-size
    contract, api.lisp:36-48; the sharded analog is
    parallel/shard.decode_streams_sharded(device_resident=True)).
    """
    data = bytes(data)
    if device_resident:
        if backend not in (None, "device"):
            raise ValueError("device_resident requires the device backend")
        backend = "device"
    if backend is None:
        backend = get_config().backend
    fmt = detect_format(data) if format == "auto" else format
    members: list[MemberInfo] = []
    parts: list = []
    fetch = not device_resident
    pos = 0

    if fmt == "raw":
        # Raw streams take a preset dictionary unconditionally
        # (zlib.decompressobj(-15, zdict=...) semantics).
        out, total, end_bit, finished, body_dev = _decode_body(
            data, zdict[-32768:], backend, output_size or 0, fetch)
        if not finished:
            raise TruncatedError("deflate stream has no final block")
        if output_size is not None and total != output_size:
            raise DeflateError(
                f"output size {total} != declared {output_size}")
        consumed = (end_bit + 7) // 8
        members.append(MemberInfo("raw", None, total, consumed))
        parts.append(out if fetch else body_dev[:total])
        pos = consumed
    elif fmt == "zlib":
        hdr = zlib_fmt.parse_header(data, zdict)
        body = data[hdr.data_offset:]
        # RFC 1950: the dictionary is applied only when the header's
        # FDICT flag requests it; preloading otherwise would let corrupt
        # too-far distances decode (diverging from zlib's error class).
        window = zdict[-32768:] if hdr.fdict else b""
        out, total, end_bit, finished, body_dev = _decode_body(
            body, window, backend, output_size or 0, fetch)
        if not finished:
            raise TruncatedError("zlib deflate body truncated")
        end = hdr.data_offset + (end_bit + 7) // 8
        stored = zlib_fmt.read_trailer(data, end)
        if verify:
            # RFC 1950: the Adler covers the uncompressed data only — a
            # preset dictionary does not feed it.
            computed = (_verify_device("adler32", body_dev, total, 1)
                        if device_resident else
                        _verify_device_or_host("adler32", body_dev, out, 1))
            zlib_fmt.check_adler(stored, computed)
        pos = end + 4
        members.append(MemberInfo("zlib", hdr, total, pos))
        parts.append(out if fetch else body_dev[:total])
    elif fmt == "gzip":
        while True:
            hdr = gzip_fmt.parse_header(data, pos)
            body = data[hdr.data_offset:]
            out, total, end_bit, finished, body_dev = _decode_body(
                body, b"", backend, 0, fetch)
            if not finished:
                raise TruncatedError("gzip deflate body truncated")
            end = hdr.data_offset + (end_bit + 7) // 8
            crc, isize = gzip_fmt.read_trailer(data, end)
            if verify:
                computed = (_verify_device("crc32", body_dev, total, 0)
                            if device_resident else
                            _verify_device_or_host("crc32", body_dev,
                                                   out, 0))
                gzip_fmt.check_trailer(crc, computed, isize, total)
            member_end = end + 8
            members.append(MemberInfo("gzip", hdr, total,
                                      member_end - pos))
            parts.append(out if fetch else body_dev[:total])
            pos = member_end
            if not multi_member:
                break
            if pos + 2 > len(data) or data[pos] != 0x1F or data[pos + 1] != 0x8B:
                break
    else:
        raise DeflateError(f"unknown format {fmt!r}", ERR_HEADER)

    if device_resident:
        import jax.numpy as jnp
        result = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
        total_len = int(sum(m.output_size for m in members))
    else:
        result = b"".join(parts)
        total_len = len(result)
    if output_size is not None and fmt != "raw" and total_len != output_size:
        raise DeflateError(
            f"output size {total_len} != declared {output_size}")
    if with_info:
        return result, StreamInfo(fmt, members, pos, data[pos:])
    return result


def decompress_into(data, out, format: str = "auto", *,
                    zdict: bytes = b"", verify: bool = True) -> int:
    """Decompress into a caller-provided writable buffer (bytearray,
    writable memoryview, or uint8 ndarray), zero-copy on the native
    path — the reference's known-size fast path (api.lisp:36-48).
    Returns the number of bytes written. Raises DeflateError if the
    buffer is too small. Bytes past the written length are unspecified
    (the fast copy loop keeps word-granular slack inside the buffer)."""
    data = bytes(data)
    fmt = detect_format(data) if format == "auto" else format
    mv = memoryview(out)
    if mv.readonly:
        raise TypeError("output buffer must be writable")
    mv = mv.cast("B")

    try:
        from .native import loader
        native = loader.available()
    except ImportError:
        native = False
    if not native:
        got = decompress(data, fmt, backend="host", zdict=zdict,
                         verify=verify)
        if len(got) > len(mv):
            raise DeflateError("output buffer too small", 11)
        mv[:len(got)] = got
        return len(got)

    from .formats import gzip_fmt as _g, zlib_fmt as _z
    pos = 0       # input offset
    wrote = 0     # output offset
    if fmt == "raw":
        n, end_bit, fin = loader.inflate_into(data, mv,
                                              window=zdict[-32768:])
        if not fin:
            raise TruncatedError("deflate stream has no final block")
        return n
    if fmt == "zlib":
        hdr = _z.parse_header(data, zdict)
        body = data[hdr.data_offset:]
        window = zdict[-32768:] if hdr.fdict else b""
        n, end_bit, fin = loader.inflate_into(body, mv, window=window)
        if not fin:
            raise TruncatedError("zlib deflate body truncated")
        if verify:
            stored = _z.read_trailer(data, hdr.data_offset
                                     + (end_bit + 7) // 8)
            _z.check_adler(stored, _zlib.adler32(mv[:n]))
        return n
    # gzip, possibly multi-member
    while True:
        hdr = _g.parse_header(data, pos)
        body = data[hdr.data_offset:]
        n, end_bit, fin = loader.inflate_into(body, mv[wrote:])
        if not fin:
            raise TruncatedError("gzip deflate body truncated")
        end = hdr.data_offset + (end_bit + 7) // 8
        crc, isize = _g.read_trailer(data, end)
        if verify:
            _g.check_trailer(crc, _zlib.crc32(mv[wrote:wrote + n]), isize, n)
        wrote += n
        pos = end + 8
        if pos + 2 > len(data) or data[pos:pos + 2] != b"\x1f\x8b":
            return wrote


def compress(data, format: str = "zlib", level: int | None = None, **kw):
    """Compress to raw / zlib / gzip framing (level None reads
    Config.level). Extra keywords pass through to the encoder:
    threads= (segment-parallel), zdict= (preset dictionary, raw/zlib),
    mtime=/name=/extra= (gzip header fields)."""
    from . import deflate_encode
    if level is None:
        level = get_config().level
    with _stage("compress", len(data)):
        return deflate_encode.compress(data, format=format, level=level, **kw)


def decompress_file(path, format: str = "auto", **kw) -> bytes:
    """Decompress from an mmap'd file (the reference's octet-pointer
    path, io-mmap.lisp / with-octet-pointer): the page cache backs the
    input; the native frontend reads it in place (loader._buf is
    zero-copy for memoryviews; framing layers copy only small headers)."""
    from .iosrc import MappedFile
    with MappedFile(path) as mf:
        view = mf.view()
        try:
            return decompress(view, format, **kw)
        finally:
            view.release()


def decompress_stream(fileobj, format: str = "auto",
                      chunk_size: int = 1 << 20, zdict: bytes = b""):
    """Generator of decompressed chunks from a binary stream (the
    stream-context role, io.lisp:61-104)."""
    from .iosrc import iter_stream
    from .streaming import Decompressor
    d = Decompressor(format, zdict=zdict)
    for piece in iter_stream(fileobj, chunk_size):
        out = d.decompress(piece)
        if out:
            yield out
    d.flush()
