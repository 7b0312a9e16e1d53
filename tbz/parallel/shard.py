"""Sharded decode: data-parallel streams + sequence-parallel checksums.

BASELINE config 5's shape: independent gzip members / deflate streams
sharded over the 'dp' mesh axis with shard_map — each device resolves and
checksums its local streams (vmapped kernels), outputs assembled in
stream order by the global output sharding. A single long stream's
checksum can instead be sequence-sharded: per-device *linear* partials
are all-gathered (tiny) and folded in order with constant GF(2) shift
matrices / length-weighted Adler merges — the codec's analog of a
tree-combined collective reduction.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from .. import checksums as cs
from ..ops import resolve as R
from ..tape import TokenTape
from .mesh import make_mesh

W = R.W


# --- batched device kernels -------------------------------------------------

@functools.partial(jax.jit, static_argnames=("out_capacity",))
def _resolve_batch(out_len, dist, root_val, n_tokens, total_out,
                   input_bytes, window, out_capacity: int):
    f = functools.partial(R._resolve_impl, out_capacity=out_capacity)
    out = jax.vmap(f)(out_len, dist, root_val, n_tokens, total_out,
                      input_bytes, window)
    # strip the per-member window prefix INSIDE the jit: an eager
    # out[:, W:] on the sharded result lowered to a whole-array XLA
    # gather per bucket (measured 60ms/bucket at 8MB — the dominant
    # serial cost of the weak-scaling curve)
    return out[:, R.W:]


@jax.jit
def _crc_batch(bodies, lens):
    f = lambda d, n: cs._crc32_device_tail(d, n, jnp.uint32(0),
                                           cs.CRC_LANE_BYTES)
    return jax.vmap(f)(bodies, jnp.asarray(lens, jnp.uint32))


@jax.jit
def _adler_batch(bodies, lens):
    f = lambda d, n: cs._adler32_device_tail(d, n, jnp.uint32(1),
                                             cs.ADLER_CHUNK)
    return jax.vmap(f)(bodies, jnp.asarray(lens, jnp.uint32))


# --- member-parallel pipeline ----------------------------------------------

def _pow2(n, floor):
    n = max(n, floor)
    return 1 << (n - 1).bit_length()


def _tokenize_members(payload: bytes, format: str):
    """Host frontend for one payload: parse EVERY member (multi-member
    gzip supported). Returns a list of member dicts."""
    from .. import api, frontend
    from ..errors import DeflateError, TruncatedError
    from ..formats import gzip_fmt, zlib_fmt

    payload = bytes(payload)
    fmt = api.detect_format(payload) if format == "auto" else format
    members = []
    pos = 0
    while True:
        if fmt == "gzip":
            hdr = gzip_fmt.parse_header(payload, pos)
            body = payload[hdr.data_offset:]
            res = frontend.tokenize(body)
            if not res.finished:
                raise TruncatedError("member body truncated")
            end = (res.end_bit + 7) // 8
            crc, isize = gzip_fmt.read_trailer(body, end)
            members.append(dict(fmt=fmt, body=body, res=res,
                                kind="crc32", expect=crc, isize=isize))
            pos = hdr.data_offset + end + 8
            if pos + 2 > len(payload) or payload[pos:pos + 2] != b"\x1f\x8b":
                # Bytes after a complete member that don't start another
                # member are benign trailing garbage — the same policy as
                # api.decompress (unused_data) and streaming.Decompressor
                # (zlib.decompressobj(31) semantics); one behavior across
                # all three surfaces.
                break
        elif fmt == "zlib":
            hdr = zlib_fmt.parse_header(payload)
            body = payload[hdr.data_offset:]
            res = frontend.tokenize(body)
            if not res.finished:
                raise TruncatedError("member body truncated")
            data_end = (res.end_bit + 7) // 8
            adler = zlib_fmt.read_trailer(body, data_end)
            # bytes past the adler trailer: benign unused_data, matching
            # api.decompress / streaming (zlib.decompressobj semantics)
            members.append(dict(fmt=fmt, body=body, res=res,
                                kind="adler32", expect=adler, isize=None))
            break
        else:
            res = frontend.tokenize(payload)
            if not res.finished:
                raise TruncatedError("member body truncated")
            members.append(dict(fmt=fmt, body=payload, res=res,
                                kind=None, expect=None, isize=None))
            break
    return members


def decode_streams_sharded(payloads: list[bytes], mesh=None,
                           format: str = "auto", verify: bool = True,
                           return_errors: bool = False,
                           device_resident: bool = False):
    """Decode independent raw/zlib/gzip streams data-parallel over the
    mesh's 'dp' axis. Returns a list of per-stream outputs (bytes), in
    stream order. With return_errors=True, a corrupt stream yields its
    exception object at its position instead of aborting the batch
    (SURVEY §5.3 per-stream error values); otherwise the first error is
    raised after all healthy streams were decoded.

    Host frontends tokenize every member (multi-member gzip included);
    members are grouped into pow2 SIZE BUCKETS so one huge stream does
    not inflate the padding of small ones; each bucket resolves and
    checksums (only the kind its framing needs) on the device mesh, and
    outputs come back in stream order.

    device_resident=True keeps decoded bytes ON DEVICE: each stream's
    entry is a list of (sharded uint8 device array, length) members
    (consumers slice arr[:length]); only the small checksum vectors
    cross to the host: decoded tensors that feed further device compute
    never pay an all-bytes D2H.

    Device errors propagate; only corrupt data becomes a per-stream
    DeflateError.
    """
    from ..errors import DeflateError
    from ..formats import gzip_fmt, zlib_fmt

    if mesh is None:
        mesh = make_mesh(sp=1)
    ndev = mesh.devices.size

    # Host frontends are per-stream independent; ctypes releases the GIL.
    # Pool sized to the host, not a fixed 4: the frontend and staging
    # stages must scale with the mesh for weak scaling to hold.
    import concurrent.futures
    import os as _os
    _n_threads = min(32, max(4, _os.cpu_count() or 4))

    def front(p):
        try:
            return _tokenize_members(p, format)
        except DeflateError as e:
            return e

    with concurrent.futures.ThreadPoolExecutor(_n_threads) as ex:
        per_stream = list(ex.map(front, payloads))

    # Flatten healthy members into work items; bucket by padded shape.
    items = []  # (stream_idx, member_idx, member)
    for si, m in enumerate(per_stream):
        if isinstance(m, Exception):
            continue
        for mi, mem in enumerate(m):
            items.append((si, mi, mem))

    buckets = {}
    for it in items:
        mem = it[2]
        t = mem["res"].tape
        key = (_pow2(len(t), 1024), _pow2(t.total_out, 4096),
               _pow2(len(mem["body"]), 1024))
        buckets.setdefault(key, []).append(it)

    member_out: dict = {}
    member_err: dict = {}

    for (T, cap, M), its in buckets.items():
        S_pad = -(-len(its) // ndev) * ndev
        # np.empty + threaded per-member row fill: the zeros+serial-copy
        # staging was the dominant serial cost of the weak-scaling curve
        # (0.26s of a 0.42s 8MB/4dev decode); large numpy copies release
        # the GIL, so rows stage in parallel. Pad rows must still be
        # zeroed (the resolver reads them).
        out_len = np.empty((S_pad, T), np.int32)
        dist = np.empty((S_pad, T), np.int32)
        root_val = np.empty((S_pad, T), np.int32)
        n_tokens = np.zeros(S_pad, np.int32)
        total_out = np.zeros(S_pad, np.int32)
        inputs = np.empty((S_pad, M), np.uint8)
        windows = np.zeros((S_pad, W), np.uint8)

        def stage_row(i):
            if i >= len(its):
                out_len[i] = 0
                dist[i] = 0
                root_val[i] = 0
                inputs[i] = 0
                return
            mem = its[i][2]
            t = mem["res"].tape
            n = len(t)
            out_len[i, :n] = t.out_len
            out_len[i, n:] = 0
            dist[i, :n] = t.dist
            dist[i, n:] = 0
            root_val[i, :n] = t.root_val
            root_val[i, n:] = 0
            n_tokens[i] = n
            total_out[i] = t.total_out
            body = mem["body"]
            inputs[i, :len(body)] = np.frombuffer(body, np.uint8)
            inputs[i, len(body):] = 0

        with concurrent.futures.ThreadPoolExecutor(_n_threads) as sx:
            list(sx.map(stage_row, range(S_pad)))

        def put(x):
            spec = P("dp", *([None] * (x.ndim - 1)))
            return jax.device_put(x, NamedSharding(mesh, spec))

        bodies = _resolve_batch(put(out_len), put(dist), put(root_val),
                                put(n_tokens), put(total_out),
                                put(inputs), put(windows), cap)
        # only the checksum kinds present in this bucket (device-
        # resident input: one D2H per bucket for the outputs, none
        # for checksums)
        kinds = {mem["kind"] for _, _, mem in its}
        crcs = (np.asarray(_crc_batch(bodies, jnp.asarray(total_out)))
                if verify and "crc32" in kinds else None)
        adlers = (np.asarray(_adler_batch(bodies, jnp.asarray(total_out)))
                  if verify and "adler32" in kinds else None)
        host = None if device_resident else np.asarray(bodies)
        for i, (si, mi, mem) in enumerate(its):
            n = int(total_out[i])
            ob = (bodies[i], n) if device_resident \
                else host[i, :n].tobytes()
            try:
                if verify and mem["kind"] == "crc32":
                    gzip_fmt.check_trailer(mem["expect"], int(crcs[i]),
                                           mem["isize"], n)
                elif verify and mem["kind"] == "adler32":
                    zlib_fmt.check_adler(mem["expect"], int(adlers[i]))
            except DeflateError as e:
                member_err[si] = e
            member_out[(si, mi)] = ob

    outputs: list = []
    first_error = None
    for si, m in enumerate(per_stream):
        if isinstance(m, Exception):
            outputs.append(m)
            first_error = first_error or m
            continue
        if si in member_err:
            outputs.append(member_err[si])
            first_error = first_error or member_err[si]
            continue
        if device_resident:
            # list of (device array, length) members
            outputs.append([member_out[(si, mi)] for mi in range(len(m))])
        else:
            outputs.append(b"".join(member_out[(si, mi)]
                                    for mi in range(len(m))))
    if first_error is not None and not return_errors:
        raise first_error
    return outputs


# --- sequence-parallel checksums (single stream sharded over devices) -------

def make_sharded_crc32(mesh, n_total_padded: int, axis: str = "dp"):
    """Build a jitted sequence-sharded CRC-32 over a (padded) uint8 array
    sharded on `axis`. Contract: bytes past `n` are zero.

    Per-shard linear CRCs fold left-to-right with a constant x^(8*C)
    matrix — the ordered tree combine of SURVEY §5.8.
    """
    ndev = mesh.shape[axis]
    assert n_total_padded % (ndev * cs.CRC_LANE_BYTES) == 0
    C = n_total_padded // ndev  # bytes per shard
    shift_c = jnp.asarray(cs._shift_bitmat_np(C))

    def shard_fn(x, n):
        # Zero-init linear CRC of the local shard (bit-matrix products).
        lin = cs._crc_linear_from_masked(x, cs.CRC_LANE_BYTES)
        parts = jax.lax.all_gather(lin, axis)  # (ndev,) tiny

        def fold(carry, part):
            return cs._gf2_apply_device(shift_c, carry) ^ part, None

        lin_total, _ = jax.lax.scan(fold, jnp.uint32(0), parts)
        zbits = jnp.uint32(8) * (jnp.uint32(n_total_padded) - n)
        lin_real = cs._crc_unshift_dynamic_device(lin_total, zbits)
        init = cs._crc_shift_dynamic_device(jnp.uint32(0xFFFFFFFF),
                                            jnp.uint32(8) * n)
        return (lin_real ^ init) ^ jnp.uint32(0xFFFFFFFF)

    fn = shard_map(shard_fn, mesh=mesh,
                   in_specs=(P(axis), P()), out_specs=P(),
                   check_vma=False)
    return jax.jit(fn)


def make_sharded_adler32(mesh, n_total_padded: int, axis: str = "dp"):
    """Sequence-sharded Adler-32 (same contract as make_sharded_crc32)."""
    ndev = mesh.shape[axis]
    assert n_total_padded % (ndev * cs.ADLER_CHUNK) == 0
    C = n_total_padded // ndev
    m = jnp.uint32(cs.ADLER_MOD)

    def local_sums(x):
        K = x.shape[0] // cs.ADLER_CHUNK
        xc = x.reshape(K, cs.ADLER_CHUNK).astype(jnp.uint32)
        w = jnp.arange(cs.ADLER_CHUNK, 0, -1, dtype=jnp.uint32)
        sa = jnp.sum(xc, axis=1, dtype=jnp.uint32) % m
        sb = jnp.sum(xc * w, axis=1, dtype=jnp.uint32) % m
        K2 = 1 << max(0, (K - 1).bit_length())
        if K2 != K:
            sa = jnp.concatenate([sa, jnp.zeros(K2 - K, jnp.uint32)])
            sb = jnp.concatenate([sb, jnp.zeros(K2 - K, jnp.uint32)])
        level = cs.ADLER_CHUNK
        while sa.shape[0] > 1:
            l2 = jnp.uint32(level % cs.ADLER_MOD)
            sb = (sb[0::2] + l2 * sa[0::2] + sb[1::2]) % m
            sa = (sa[0::2] + sa[1::2]) % m
            level *= 2
        # Pow2 chunk padding added (K2*chunk - C) phantom trailing zeros to
        # this shard; remove their weight so the fold sees exactly C bytes.
        z_local = jnp.uint32((K2 * cs.ADLER_CHUNK - C) % cs.ADLER_MOD)
        sb0 = (sb[0] + m - (z_local * sa[0]) % m) % m
        return sa[0], sb0

    def shard_fn(x, n):
        sa, sb = local_sums(x)
        sas = jax.lax.all_gather(sa, axis)
        sbs = jax.lax.all_gather(sb, axis)
        c_mod = jnp.uint32(C % cs.ADLER_MOD)

        def fold(carry, part):
            ca, cb = carry
            pa, pb = part
            return ((ca + pa) % m, (cb + c_mod * ca + pb) % m), None

        (sa_t, sb_t), _ = jax.lax.scan(fold, (jnp.uint32(0), jnp.uint32(0)),
                                       (sas, sbs))
        z = (jnp.uint32(n_total_padded) - n) % m
        sb_t = (sb_t + m - (z * sa_t) % m) % m
        a = (jnp.uint32(1) + sa_t) % m
        b = ((n % m) + sb_t) % m
        return (b << 16) | a

    fn = shard_map(shard_fn, mesh=mesh,
                   in_specs=(P(axis), P()), out_specs=P(),
                   check_vma=False)
    return jax.jit(fn)
