"""Device-resident fused decode: batched tokenize -> on-device splice ->
pointer-doubling resolve, with ONLY metadata crossing device->host.

The batched tokenizer's host-tape consumer (ops/batched.py) fetches the
compacted token tape to the host, span-plans it in C++ and uploads the
plan again — yet the pointer-doubling resolver (ops/resolve.py) needs no
host planner at all. This module keeps the tokens on the device:

  1. HOST    scan_headers + ONE batched kernel launch (ops/batched
             machinery, shared).
  2. D2H     the metadata header ALONE (7L+2B+1 ints, ~tens of KB): the
             compacted tokens stay on device.
  3. HOST    the shared meta-only chain walk (batched._walk) produces a
             SPLICE PLAN — an ordered list of ranges, each either a slice
             of the on-device compact tape or a small host-decoded token
             run (stored blocks, scanner misses, junction gap joins).
  4. H2D     the plan (3 small int32 arrays) + host tokens (3 arrays).
  5. DEVICE  one fused kernel: range-map gather assembles the true token
             chain from the on-device tape + uploaded host tokens,
             validates every distance (first-bad index, zlib's sequential
             error order preserved against walk-raised structural
             errors), and resolves LZ77 by pointer doubling
             (resolve._resolve_core). Output layout:
             uint8[4 + W + cap] = [first_bad i32 | window | output] so a
             one-shot consumer fetches error word + output in ONE D2H and
             a device-resident consumer fetches 4 bytes.

The reference's decode is byte-serial (deflate.lisp:640-720,244-359);
here all control decisions ride in tiny metadata, and all byte work is
data-parallel on the device.
"""

from __future__ import annotations

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from .. import errors as E
from . import batched as B
from . import gather as G
from ..tape import STORED_FLAG
from .resolve import W, _pad_pow2, _resolve_core

_BIG = np.int32(2**31 - 1)


def _splice_resolve(compact, data32, window, rng_dst, rng_src, rng_kind,
                    host_ol, host_di, host_rv, n_total, window_len,
                    n_out: int, T: int, R: int, H: int, cap: int,
                    has_stored: bool):
    """ONE device call: token-chain assembly + distance check + resolve.

    compact: int32[n_out + 1] on-device token tape (batched kernel
    layout: len 9b | field 16b; slot n_out is scatter junk — masked).
    Ranges r cover token-chain slots [rng_dst[r], rng_dst[r] + n_r);
    kind 0 reads compact[rng_src[r] + j], kind 1 reads the host arrays.
    Padding ranges carry dst = T (dropped by the scatter)."""
    i = jnp.arange(T, dtype=jnp.int32)
    marks = jnp.zeros(T, jnp.int32).at[rng_dst].add(1, mode="drop")
    rid = jnp.clip(jnp.cumsum(marks) - 1, 0, R - 1)
    rz = jnp.zeros_like(rng_src)
    rrows = G.take(jnp.stack([rng_src, rng_dst, rng_kind,
                                   rz, rz, rz, rz, rz], axis=1), rid)
    pos = rrows[:, 0] + (i - rrows[:, 1])
    kind = rrows[:, 2]
    valid = i < n_total

    tok = G.take(compact, jnp.where(kind == 0, pos, 0))
    hi = jnp.clip(jnp.where(kind == 1, pos, 0), 0, H - 1)
    ln_d = tok & 0x1FF
    fld = tok >> 9
    is_lit = ln_d == 1
    from_host = kind == 1
    hz = jnp.zeros_like(host_ol)
    hrows = jnp.stack([host_ol, host_di, host_rv,
                       hz, hz, hz, hz, hz], axis=1)
    hg = G.take(hrows, hi)  # width-8 row gather, host-token fields
    ol = jnp.where(valid, jnp.where(from_host, hg[:, 0], ln_d), 0)
    di = jnp.where(valid & (ol > 0),
                   jnp.where(from_host, hg[:, 1],
                             jnp.where(is_lit, 0, fld + 1)), 0)
    rv = jnp.where(valid,
                   jnp.where(from_host, hg[:, 2],
                             jnp.where(is_lit, fld, 0)), 0)

    # zlib's "distance too far back": dist may reach window_len bytes
    # before the first output byte (deflate.lisp:691 checks inline; the
    # host-splice consumer checks per block — here one global pass in
    # chain order is the same sequential-order predicate)
    pref = jnp.cumsum(ol, dtype=jnp.int32) - ol
    bad = (di > pref + window_len) & (di > 0)
    first_bad = jnp.min(jnp.where(bad, i, _BIG))

    data_u8 = jax.lax.bitcast_convert_type(
        data32, jnp.uint8).reshape(-1)
    buf = _resolve_core(ol, di, rv, n_total, data_u8, window, cap,
                        has_stored)
    fb = jax.lax.bitcast_convert_type(
        first_bad[None].astype(jnp.int32), jnp.uint8).reshape(4)
    return jnp.concatenate([fb, buf])


@functools.lru_cache(maxsize=64)
def _get_kernel(n_out: int, T: int, R: int, H: int, cap: int,
                has_stored: bool):
    """Jitted splice+resolve for one pow2-padded shape class; the LRU
    bounds how many compiled executables a long-lived process pins."""
    return jax.jit(functools.partial(
        _splice_resolve, n_out=n_out, T=T, R=R, H=H, cap=cap,
        has_stored=has_stored))


class _PlanBuilder:
    """Collects the walk's emits into a range plan + host token arrays,
    tracking token-chain position and output bytes (meta.nbytes sizes the
    device ranges without touching token values)."""

    def __init__(self, meta):
        self.meta = meta
        self.dst: list = []     # (dst_start, src_start, kind)
        self.n_tok = 0          # token-chain length so far
        self.n_bytes = 0        # output bytes so far
        self.h_ol: list = []
        self.h_di: list = []
        self.h_rv: list = []
        self.n_host = 0
        self.has_stored = False

    def emit_dev(self, lane, a, b):
        # coalesce ranges contiguous in BOTH chain and compact space
        if (self.dst and self.dst[-1][2] == 0
                and self.dst[-1][1] + (self.n_tok - self.dst[-1][0]) == a):
            pass  # extend implicitly: same arithmetic progression
        else:
            self.dst.append((self.n_tok, a, 0))
        self.n_tok += b - a
        self.n_bytes += int(self.meta.nbytes[lane])

    def emit_host(self, ol, di, rv):
        if len(ol) == 0:
            return
        if (self.dst and self.dst[-1][2] == 1
                and self.dst[-1][1] + (self.n_tok - self.dst[-1][0])
                == self.n_host):
            pass
        else:
            self.dst.append((self.n_tok, self.n_host, 1))
        self.h_ol.append(ol)
        self.h_di.append(di)
        self.h_rv.append(rv)
        if np.any(rv & STORED_FLAG):
            self.has_stored = True
        self.n_tok += len(ol)
        self.n_host += len(ol)
        self.n_bytes += int(ol.astype(np.int64).sum())


def decode_stream_fused(data: bytes, window: bytes = b"",
                        chunk_bits: int = 8192, fetch: bool = True,
                        collect_stats: bool = False):
    """Whole-stream decode, device-resident end to end.

    Returns (out_bytes | None, dev_body uint8[cap], total, end_bit,
    stats) — out_bytes is None when fetch=False (device_resident
    consumers slice dev_body[:total]); returns None entirely when the
    fused path can't run (no native scanner / no dynamic candidates /
    stream too large) so the caller falls back. Raises the canonical
    frontend errors with zlib's sequential ordering: a bad distance in
    already-emitted tokens outranks any structural error the walk hits
    later in the stream."""
    data = bytes(data)
    nbits = len(data) * 8
    try:
        from ..native import loader as NL
        if not NL.available():
            return None
    except ImportError:
        return None
    if nbits >= (1 << 31) or len(data) < 256:
        return None

    stats = B._new_stats()
    scan, plan, flat_d, data32 = B._scan_and_launch(data, chunk_bits,
                                                    stats)
    if scan is None:
        return None

    # D2H #1: metadata header ONLY — the token tape stays on device
    hdr_len = plan.hdr_len
    t0 = time.perf_counter()
    meta = B._parse_meta(np.asarray(flat_d[:hdr_len]), plan)
    stats["fetch_ms"] = (time.perf_counter() - t0) * 1e3
    stats["fetches"] = 1
    stats["token_d2h_bytes"] = 0
    stats["meta_d2h_bytes"] = 4 * hdr_len

    pb = _PlanBuilder(meta)
    t0 = time.perf_counter()
    walk_err = None
    end_bit = None
    try:
        end_bit = B._walk(data, scan, plan, meta, stats,
                          pb.emit_dev, pb.emit_host)
    except E.DeflateError as e:   # includes TruncatedError
        walk_err = e
    stats["walk_ms"] = (time.perf_counter() - t0) * 1e3

    # ---- build + upload the splice plan, launch the fused kernel ----
    t0 = time.perf_counter()
    n_total = pb.n_tok
    total = pb.n_bytes
    if walk_err is not None and n_total == 0:
        raise walk_err
    if total >= (1 << 31):
        return None  # int32 coordinate space; caller falls back
    nr = len(pb.dst)
    T = _pad_pow2(max(n_total, 1))
    R = _pad_pow2(max(nr, 1), floor=64)
    H = _pad_pow2(max(pb.n_host, 1), floor=64)
    cap = _pad_pow2(total, floor=4096)
    rng = np.full((3, R), 0, np.int32)
    rng[0, :] = T  # padding ranges: dst out of scatter range
    for r, (d, s, k) in enumerate(pb.dst):
        rng[0, r], rng[1, r], rng[2, r] = d, s, k
    h_ol = np.zeros(H, np.int32)
    h_di = np.zeros(H, np.int32)
    h_rv = np.zeros(H, np.int32)
    if pb.n_host:
        h_ol[:pb.n_host] = np.concatenate(pb.h_ol)
        h_di[:pb.n_host] = np.concatenate(pb.h_di)
        h_rv[:pb.n_host] = np.concatenate(pb.h_rv)
    win = np.frombuffer(bytes(window), np.uint8)[-W:]
    wpad = np.zeros(W, np.uint8)
    if len(win):
        wpad[W - len(win):] = win
    compact = jax.lax.slice(flat_d, (hdr_len,), (hdr_len + plan.n_out + 1,))
    kern = _get_kernel(plan.n_out, T, R, H, cap, pb.has_stored)
    ret = kern(compact, data32, jnp.asarray(wpad), jnp.asarray(rng[0]),
               jnp.asarray(rng[1]), jnp.asarray(rng[2]),
               jnp.asarray(h_ol), jnp.asarray(h_di), jnp.asarray(h_rv),
               np.int32(n_total), np.int32(len(win)))
    stats["resolve_launch_ms"] = (time.perf_counter() - t0) * 1e3

    # ---- fetch: error word (+ output when fetch=True) in ONE D2H ----
    t0 = time.perf_counter()
    if fetch and walk_err is None:
        head = np.asarray(ret[:4 + W + total])
        first_bad = int(head[:4].view(np.int32)[0])
        out = head[4 + W:].tobytes()
    else:
        first_bad = int(np.asarray(ret[:4]).view(np.int32)[0])
        out = None
    stats["out_fetch_ms"] = (time.perf_counter() - t0) * 1e3
    if first_bad < n_total:
        E.raise_for_code(E.ERR_BAD_DISTANCE)
    if walk_err is not None:
        raise walk_err
    dev_body = ret[4 + W:]
    if collect_stats:
        return out, dev_body, total, end_bit, stats
    return out, dev_body, total, end_bit
