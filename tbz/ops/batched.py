"""Batched multi-block speculative decode: the whole stream in ONE
device call (round 4; round 5 adds the meta-only walk that feeds the
fused device resolve in ops/fused.py).

The round-2/3 production path (ops/speculative.py) pays one device
round trip per DEFLATE block because block N+1's header position is
only known after block N's symbol stream is decoded. The native header
scanner (frontend.cc tbz_scan_headers) removes that dependency: it
speculatively finds every plausible dynamic block header in the bit
stream up front (acceptance identical to the real parse), so all
blocks' tables and lane plans can ship to the device together:

  1. HOST   scan_headers -> candidate headers (true headers always
            found; rare false positives culled by the chain walk).
  2. DEVICE one fused call: vmapped flat-table build for all B
            candidates, lockstep lane decode over ALL lanes of ALL
            segments (per-lane table index), then an on-device stitch
            scan (entry-chain merge over lanes) and token compaction.
  3. HOST   chain walk over blocks, driven by METADATA ONLY (per-lane
            merge flags / offsets / exits): splice compacted segment
            tokens, gap-decode any unsynced/unscanned span with the
            native sequential decoder (correctness never depends on
            speculation), validate distances per block.

The walk needs no token values, so it has two consumers:
  - tokenize_stream_batched (host tape): fetches meta + a bounded token
    prefix in one D2H and splices on the host (test_three_way parity).
  - ops/fused.decode_stream_fused (device output): fetches ONLY the
    metadata; the compacted tokens never leave the device — the merge
    plan from this walk drives an on-device resolve.

Bit-identical to the other frontends (tests/test_three_way.py). The
reference's decode is strictly sequential (deflate.lisp:640-720); the
parallel formulation follows the public parallel-inflate literature
(PAPERS.md) and is original to this codebase.
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from .. import errors as E
from ..tape import STORED_FLAG, FrontendResult, TokenTape
from .tokenize_device import (_entry_consts, build_flat_table,
                              _e_nbits, _e_op, _e_extra, _e_val)

_TBITS = 15  # flat tables are 2^15 entries (build_flat_table)

# Lanes decode EXT_BITS past their nominal end so consecutive lanes
# OVERLAP: lane l+1 starts mid-symbol and self-synchronizes onto the
# true symbol chain within a few symbols; the merge point is the first
# symbol-start position both lanes visited. The device stitch finds it
# with a dense (HEAD x TAIL) equality matrix — pure vector compares, no
# gathers — between lane l's last TAIL starts and lane l+1's first HEAD
# starts. No intersection (slow convergence, degenerate codes, errors)
# falls back to host sequential decode, so exactness never depends on
# synchronization.
EXT_BITS = 384  # junction convergence: median ~50 bits, p90 ~140,
                # heavy tail (measured on L9 source-code streams); 384
                # catches ~99% — misses cost one host-joined junction
HEAD = 96   # merge candidates tested in the joining lane
TAIL = 144  # trailing starts carried from the previous lane

SYM_BITS_EXPECT = 7  # lane-tape sizing: expected bits/symbol (see
                     # _build_plan; overflow degrades to one host join)

# flag bits in the per-lane stitch metadata
F_MERGED = 1
F_SKIP = 2
F_DEAD = 4
F_EOB = 8


def _lanes_multi(data32, lit_flat, dist_flat, tbl_off, lane_starts,
                 lane_ends, total_bits, L: int, S: int):
    """Lockstep decode of L lanes x S steps, each lane reading its own
    segment's tables via a per-lane offset into the flattened (B*2^15)
    table arrays. The whole symbol (code + extra + dist code + dist
    extra, <= 63 bits past the symbol start) is read from ONE row
    gather into an overlapping 3-word-row view of the stream: one (L,3)
    row gather replaces three element gathers per lane-step."""
    NW = data32.shape[0] - 2
    rows = jnp.stack([data32[0:NW], data32[1:NW + 1], data32[2:NW + 2]],
                     axis=1)

    def step(carry, _):
        bit, active, bad = carry
        wi = (bit >> 5).astype(jnp.int32)
        w = rows[wi]
        w0 = w[:, 0]
        w1 = w[:, 1]
        w2 = w[:, 2]

        def peek_at(p, n):
            # p in [bit, bit+48], n <= 15: the needed bits live in words
            # wi..wi+2; the second word's contribution is masked out
            # whenever it would have been word 3 (off <= 17 there).
            s = (p >> 5) - wi
            off = (p & 31).astype(jnp.uint32)
            a = jnp.where(s == 0, w0, jnp.where(s == 1, w1, w2))
            b = jnp.where(s == 0, w1, w2)
            hi = jnp.where(off > 0, b << ((32 - off) & 31), jnp.uint32(0))
            return ((a >> off) | hi) & jnp.uint32((1 << n) - 1)

        e = lit_flat[tbl_off + peek_at(bit, 15).astype(jnp.int32)]
        nb = _e_nbits(e)
        op = _e_op(e)
        ex = _e_extra(e)
        p1 = bit + nb
        ebits = peek_at(p1, 13).astype(jnp.int32) & (
            (1 << jnp.clip(ex, 0, 13)) - 1)
        length = _e_val(e) + ebits
        p2 = p1 + jnp.where(op == C.OP_MATCH, ex, 0)
        de = dist_flat[tbl_off + peek_at(p2, 15).astype(jnp.int32)]
        dnb = _e_nbits(de)
        p3 = p2 + jnp.where(op == C.OP_MATCH, dnb, 0)
        dex = _e_extra(de)
        debits = peek_at(p3, 13).astype(jnp.int32) & (
            (1 << jnp.clip(dex, 0, 13)) - 1)
        d = _e_val(de) + debits
        p4 = p3 + jnp.where(op == C.OP_MATCH, dex, 0)

        is_lit = op == C.OP_LITERAL
        is_end = op == C.OP_END
        is_match = op == C.OP_MATCH
        invalid = (op == C.OP_INVALID) | (is_match &
                                          (_e_op(de) != C.OP_MATCH))
        next_bit = jnp.where(is_match, p4, bit + nb)
        underrun = next_bit > total_bits

        emit = active & ~invalid & ~underrun
        packed = (jnp.where(emit & ~is_end,
                            jnp.where(is_lit, 1, length), 0)
                  | (jnp.where(emit & is_lit, _e_val(e), 0) << 9)
                  | (jnp.where(emit & is_end, 1, 0) << 17))
        ys = (jnp.where(emit, bit, -1),
              packed,
              jnp.where(emit & is_match, d, 0))
        bad = bad | (active & (invalid | underrun))
        crossed = next_bit >= lane_ends
        active = emit & ~is_end & ~crossed
        bit = jnp.where(emit, next_bit, bit)
        return (bit, active, bad), ys

    init = (lane_starts.astype(jnp.int32), jnp.ones(L, jnp.bool_),
            jnp.zeros(L, jnp.bool_))
    (exit_bit, _, bad), (starts, packed, dist) = jax.lax.scan(
        step, init, None, length=S)
    return starts.T, packed.T, dist.T, exit_bit, ~bad


@functools.partial(jax.jit,
                   static_argnames=("L", "S", "B", "n_out"))
def _batched_kernel(data32, lit_lens, dist_lens, tbl_idx, lane_starts,
                    lane_ends_ext, seg_id, seg_sym, total_bits,
                    L: int, S: int, B: int, n_out: int):
    """Table build + lane decode + stitch + compaction, ONE device call.

    Returns one flat int32 array: a [7L + 2B + 1] metadata header
    [merge_pos | n_valid | flags | handoff | exits | out_off | nbytes |
     lit_errs | dist_errs | total] followed by the [n_out + 1] compacted
    tokens (len 9b | field 16b; field = literal byte when len == 1,
    dist-1 otherwise) in chain order — the caller fetches the header
    plus a bounded token prefix in one D2H (or, on the fused path, the
    header alone: ops/fused consumes the tokens in place).
    """
    lit_c, dist_c, _ = (jnp.asarray(x) for x in _entry_consts())
    lit_tabs, lit_errs = jax.vmap(
        lambda ln: build_flat_table(ln, lit_c, 288, True))(lit_lens)
    dist_tabs, dist_errs = jax.vmap(
        lambda ln: build_flat_table(ln, dist_c, 32, True))(dist_lens)
    lit_flat = lit_tabs.reshape(B << _TBITS)
    dist_flat = dist_tabs.reshape(B << _TBITS)
    tbl_off = tbl_idx << _TBITS

    starts, packed, dist, exits, ok = _lanes_multi(
        data32, lit_flat, dist_flat, tbl_off, lane_starts,
        lane_ends_ext, total_bits, L, S)

    n_syms = jnp.sum(starts >= 0, axis=1).astype(jnp.int32)
    # a lane is usable if it ended cleanly; a lane that FILLED its tape
    # (degenerate short codes) still splices its prefix — the next
    # junction simply fails to intersect its mid-lane tail and the host
    # joins from this lane's exit (prefix + join instead of all-join)
    usable = ok
    last = jnp.clip(n_syms - 1, 0, S - 1)
    last_packed = jnp.take_along_axis(packed, last[:, None], 1)[:, 0]
    has_eob = (n_syms > 0) & (((last_packed >> 17) & 1) == 1)
    big = jnp.int32(2 ** 31 - 1)
    starts_s = jnp.where(starts < 0, big, starts)
    # a lane whose table build failed can't be trusted (host rebuilds
    # and re-raises); treat as unusable
    tbl_bad = (lit_errs[tbl_idx] != 0) | (dist_errs[tbl_idx] != 0)
    usable = usable & ~tbl_bad

    def stitch(carry, x):
        tail, tail_idx, cur_seg, state = carry
        (srow, n, use, eob, seg, ssym) = x
        new_seg = seg != cur_seg
        state = jnp.where(new_seg, 0, state)
        # virtual single-element tail for a segment's first lane: the
        # true entry is its exact start position
        tail = jnp.where(new_seg,
                         jnp.full(TAIL, big, jnp.int32).at[0].set(ssym),
                         tail)
        tail_idx = jnp.where(new_seg, jnp.zeros(TAIL, jnp.int32),
                             tail_idx)
        skip = state != 0
        # dense head x tail intersection: first common visited position
        head = srow[:HEAD]
        eq = (head[:, None] == tail[None, :]) & (tail[None, :] < big) \
            & (head[:, None] < big)
        hit_m = jnp.any(eq, axis=1)
        any_hit = jnp.any(hit_m)
        m0 = jnp.argmax(hit_m).astype(jnp.int32)
        k_for_m = jnp.argmax(eq, axis=1).astype(jnp.int32)
        k0 = k_for_m[m0]
        cut_prev = jnp.where(any_hit, tail_idx[k0], big)
        merged = use & ~skip & any_hit & (m0 < n)
        m0 = jnp.where(merged, m0, 0)
        cut_prev = jnp.where(merged & ~new_seg, cut_prev, big)
        dead_now = ~skip & ~merged
        # handoff: the bit position where this lane's spliced tokens
        # begin (the host verifies a gap-join lands EXACTLY here)
        handoff = jnp.where(merged, srow[m0], jnp.int32(-1))
        state = jnp.where(merged & eob, jnp.int32(2), state)
        flags = (jnp.where(merged, F_MERGED, 0)
                 | jnp.where(skip, F_SKIP, 0)
                 | jnp.where(dead_now, F_DEAD, 0)
                 | jnp.where(merged & eob, F_EOB, 0))
        # Next lane's tail: this lane's last TAIL starts at/after its
        # own merge point. A DEAD lane seeds the tail from its own
        # speculative chain — lanes converge transitively, so the chain
        # continues and only the one-junction gap is host-decoded
        # (verified against the next handoff).
        base = jnp.clip(n - TAIL, 0, S - TAIL)
        t_new = jax.lax.dynamic_slice(srow, (base,), (TAIL,))
        ti_new = base + jnp.arange(TAIL, dtype=jnp.int32)
        t_new = jnp.where((ti_new >= m0) & (ti_new < n), t_new, big)
        keep = skip  # post-EOB lanes don't disturb the (unused) tail
        tail = jnp.where(keep, tail, t_new)
        tail_idx = jnp.where(keep, tail_idx, ti_new)
        return ((tail, tail_idx, seg, state),
                (m0, cut_prev, flags.astype(jnp.int32), handoff))

    init = (jnp.full(TAIL, big, jnp.int32), jnp.zeros(TAIL, jnp.int32),
            jnp.int32(-1), jnp.int32(0))
    _, (mpos, cut_prev, flags, handoff) = jax.lax.scan(
        stitch, init,
        (starts_s, n_syms, usable, has_eob, seg_id, seg_sym))

    # lane l's valid range ends where lane l+1 takes over (cut), at its
    # EOB, or at its last symbol
    cut_next = jnp.concatenate([cut_prev[1:], jnp.array([big])])
    merged_f = (flags & F_MERGED) != 0
    end_idx = jnp.minimum(cut_next,
                          n_syms - jnp.where(has_eob, 1, 0))
    nv = jnp.where(merged_f, jnp.clip(end_idx - mpos, 0, S), 0)

    off = jnp.cumsum(nv) - nv
    total = jnp.sum(nv)

    # compact tokens: len 9b | field 16b (field = rv for literals,
    # dist-1 for matches); chain order = lane order within segments
    ln = packed & 0x1FF
    rv = (packed >> 9) & 0xFF
    field = jnp.where(ln == 1, rv, dist - 1)
    tok = ln | (field << 9)
    col = jnp.arange(S, dtype=jnp.int32)[None, :]
    sel = (col >= mpos[:, None]) & (col < (mpos + nv)[:, None])
    # per-lane OUTPUT byte counts ride in the metadata so the fused
    # path can size the resolve buffers without touching the tokens
    nbytes = jnp.sum(jnp.where(sel, ln, 0), axis=1).astype(jnp.int32)
    tgt = jnp.where(sel, off[:, None] + (col - mpos[:, None]),
                    jnp.int32(n_out))
    compact = jnp.zeros(n_out + 1, jnp.int32).at[tgt.ravel()].set(
        tok.ravel(), mode="drop")

    meta = jnp.concatenate([
        mpos, nv, flags, handoff, exits, off, nbytes,
        lit_errs.astype(jnp.int32), dist_errs.astype(jnp.int32),
        total[None]])
    # ONE flat result: metadata followed by the compacted tokens, so
    # the host fetches meta + a bounded token prefix in a single D2H
    return jnp.concatenate([meta, compact])


class Plan(NamedTuple):
    """Kernel launch plan for one stream."""
    L: int                  # padded lane count (pow2)
    S: int                  # max symbols per lane
    B: int                  # padded segment/table count (pow2)
    n_out: int              # compact token capacity (L*S)
    hdr_len: int            # metadata ints preceding the tokens
    bound: int              # expected-case token-prefix fetch size
    Ln: int                 # real lane count
    Bn: int                 # real candidate count
    covered: int            # total lane-covered bits
    lane_starts: np.ndarray
    lane_ends: np.ndarray   # EXT_BITS-extended
    seg_id: np.ndarray
    tbl_idx: np.ndarray
    seg_sym: np.ndarray
    lit_pad: np.ndarray     # (B, 288) code lengths
    dist_pad: np.ndarray    # (B, 32)


def _plan_lanes(sym_bits, seg_ends, chunk_bits):
    """Lane layout over candidate segments: segment i's lanes tile
    [sym_bits[i], seg_ends[i]). Returns int32 arrays (starts, ends,
    seg_id) in global chain order."""
    starts, ends, seg = [], [], []
    for i, (s0, s1) in enumerate(zip(sym_bits, seg_ends)):
        n = max(1, -(-(s1 - s0) // chunk_bits))
        ls = s0 + np.arange(n, dtype=np.int64) * chunk_bits
        le = np.minimum(ls + chunk_bits, s1)
        starts.append(ls)
        ends.append(le)
        seg.append(np.full(n, i, np.int32))
    return (np.concatenate(starts).astype(np.int32),
            np.concatenate(ends).astype(np.int32),
            np.concatenate(seg))


def _build_plan(nbits: int, scan, chunk_bits: int) -> Plan:
    """Lane/table plan for one stream from the scanner's candidates.
    `scan` is the scan_headers tuple (hdr, symb, bfin, hlit, hdist,
    lens)."""
    hdr, symb, _bfin, hlit, hdist, lens = scan
    Bn = len(hdr)
    seg_ends = np.append(hdr[1:], nbits)
    lane_starts, lane_ends, seg_id = _plan_lanes(symb, seg_ends,
                                                 chunk_bits)
    Ln = len(lane_starts)
    L = 1 << max(4, (Ln - 1).bit_length())
    B = 1 << max(1, (Bn - 1).bit_length())
    # Lane tape sized for realistic symbol density, not the 5.33
    # bits/sym worst case: a lane that fills its tape still splices its
    # prefix and costs one host gap join (see _batched_kernel), so S is
    # a perf knob, not a correctness bound. Real streams average
    # ~11-12 bits/sym; 7 covers dense-literal text with margin while
    # keeping the scan's step count down.
    S = max(256, (chunk_bits + EXT_BITS) // SYM_BITS_EXPECT)
    covered = int((lane_ends.astype(np.int64)
                   - lane_starts.astype(np.int64)).sum()) + Ln * EXT_BITS
    # lanes decode EXT_BITS past their nominal end (overlap merge)
    lane_ends = lane_ends + EXT_BITS
    # pad: extra lanes point at segment 0's table, cover nothing
    pad = L - Ln
    lane_starts = np.concatenate([lane_starts, np.zeros(pad, np.int32)])
    lane_ends = np.concatenate([lane_ends, np.zeros(pad, np.int32)])
    seg_id = np.concatenate([seg_id, np.zeros(pad, np.int32)])
    tbl_idx = seg_id.copy()
    seg_sym = np.zeros(L, np.int32)
    seg_sym[:Ln] = symb[seg_id[:Ln]]
    lit_pad = np.zeros((B, 288), np.int32)
    dist_pad = np.zeros((B, 32), np.int32)
    for i in range(Bn):
        lit_pad[i, :hlit[i]] = lens[i, :hlit[i]]
        dist_pad[i, :hdist[i]] = lens[i, hlit[i]:hlit[i] + hdist[i]]
    n_out = L * S
    hdr_len = 7 * L + 2 * B + 1
    # token-prefix fetch sized by the EXPECTED token count: real streams
    # average ~11-12 bits/symbol, so covered//9 over-covers typical
    # content while fetching ~2.5x less than the worst-case covered//5
    # budget; a degenerate (short-code-heavy) stream that exceeds it
    # pays one extra tail round trip (stats['fetches'] == 2, asserted
    # observable by tests/test_batched.py)
    bound = min(n_out, covered // 9 + Ln)
    return Plan(L, S, B, n_out, hdr_len, bound, Ln, Bn, covered,
                lane_starts, lane_ends, seg_id, tbl_idx, seg_sym,
                lit_pad, dist_pad)


def _launch(data32, plan: Plan, nbits: int):
    """device_put the plan and launch the batched kernel."""
    dev = jax.device_put((jnp.asarray(plan.lit_pad),
                          jnp.asarray(plan.dist_pad),
                          jnp.asarray(plan.tbl_idx),
                          jnp.asarray(plan.lane_starts),
                          jnp.asarray(plan.lane_ends),
                          jnp.asarray(plan.seg_id),
                          jnp.asarray(plan.seg_sym)))
    return _batched_kernel(data32, *dev, np.int32(nbits),
                           plan.L, plan.S, plan.B, plan.n_out)


class Meta(NamedTuple):
    """Parsed kernel metadata header (host copies)."""
    nv: np.ndarray
    flags: np.ndarray
    handoff: np.ndarray
    exits: np.ndarray
    off: np.ndarray
    nbytes: np.ndarray
    lit_errs: np.ndarray
    dist_errs: np.ndarray
    total: int


def _parse_meta(raw: np.ndarray, plan: Plan) -> Meta:
    L, B = plan.L, plan.B
    return Meta(nv=raw[L:2 * L], flags=raw[2 * L:3 * L],
                handoff=raw[3 * L:4 * L], exits=raw[4 * L:5 * L],
                off=raw[5 * L:6 * L], nbytes=raw[6 * L:7 * L],
                lit_errs=raw[7 * L:7 * L + B],
                dist_errs=raw[7 * L + B:7 * L + 2 * B],
                total=int(raw[7 * L + 2 * B]))


_empty = np.empty(0, np.int32)


def _walk(data: bytes, scan, plan: Plan, meta: Meta, stats,
          emit_dev, emit_host, end_block=lambda: None) -> int:
    """The host chain walk, driven by metadata only (no token values):
    reads block headers from the bit stream, decides per lane whether
    its compacted token range splices or a gap must be host-decoded,
    and reports the stream as an ordered sequence of
      emit_dev(lane, a, b)        — compact-token range [a, b)
      emit_host(ol, di, rv)       — host-generated tokens (stored
                                    blocks, unscanned blocks, junction
                                    gap joins)
      end_block()                 — after each block completes (the
                                    host-splice consumer validates
                                    distances per block here, so a bad
                                    distance in block N raises before a
                                    structural error in block N+1 —
                                    zlib's sequential error order)
    Returns end_bit. Raises the canonical frontend errors for
    structural problems; DISTANCE validation is the emitter's job
    (host splice: emit_block; fused: the device check)."""
    from ..bitreader import BitReader
    from ..errors import DeflateError, ERR_BAD_BLOCK_TYPE, \
        ERR_STORED_LEN_MISMATCH
    from .. import reference as R
    from ..native import loader as NL

    hdr, symb, _bfin, hlit, hdist, lens = scan
    Bn, Ln = plan.Bn, plan.Ln
    seg_id = plan.seg_id
    # lanes of each segment (contiguous ranges in lane order)
    seg_first = np.searchsorted(seg_id[:Ln], np.arange(Bn))
    seg_last = np.searchsorted(seg_id[:Ln], np.arange(Bn), side="right")
    hdr_pos = {int(h): i for i, h in enumerate(hdr)}

    def gap_to_eob(bit, ll, dl):
        """Native sequential decode to end-of-block; returns end bit."""
        ol, di, rv, end_bit, _, eob = NL.gap_decode(
            data, bit, ll, dl, _empty, 1 << 62, cap=1 << 16)
        if not eob:
            raise E.TruncatedError(
                "block symbol stream ended before its end-of-block code")
        stats["gap_syms"] += len(ol)
        emit_host(np.asarray(ol, np.int32), np.asarray(di, np.int32),
                  np.asarray(rv, np.int32))
        return end_bit

    def gap_join(bit, stop_bit, ll, dl):
        """Native sequential decode of a dead junction: walk the true
        chain from `bit` up to `stop_bit` (the next lane's handoff).
        Returns (landed_exactly, hit_eob, end_bit)."""
        ol, di, rv, end_bit, _, eob = NL.gap_decode(
            data, bit, ll, dl, _empty, stop_bit, cap=1 << 16)
        stats["gap_syms"] += len(ol)
        if len(ol):
            emit_host(np.asarray(ol, np.int32), np.asarray(di, np.int32),
                      np.asarray(rv, np.int32))
        return end_bit == stop_bit, eob, end_bit

    br = BitReader(data, 0)
    while True:
        bfinal = bool(br.bits(1))
        btype = br.bits(2)
        if btype == C.BTYPE_RESERVED:
            raise DeflateError("invalid block type 3", ERR_BAD_BLOCK_TYPE)
        stats["blocks"] += 1
        if btype == C.BTYPE_STORED:
            br.align_to_byte()
            ln0 = br.bits(16)
            nlen = br.bits(16)
            if ln0 != (~nlen & 0xFFFF):
                raise DeflateError("stored LEN/NLEN mismatch",
                                   ERR_STORED_LEN_MISMATCH)
            if ln0:
                o = br.bit_position() >> 3
                br.read_bytes_aligned(ln0)
                emit_host(np.array([ln0], np.int32),
                          np.array([0], np.int32),
                          np.array([STORED_FLAG | o], np.int32))
        else:
            hb = br.bit_position() - 3
            si = hdr_pos.get(hb) if btype == C.BTYPE_DYNAMIC else None
            if si is None or meta.lit_errs[si] or meta.dist_errs[si]:
                # static block, scanner miss, or device table failure:
                # host header parse (authoritative error classes) +
                # native sequential decode of this block
                if btype == C.BTYPE_STATIC:
                    ll = C.FIXED_LITLEN_LENGTHS
                    dl = C.FIXED_DIST_LENGTHS
                else:
                    lns, hl, hd = R._read_dynamic_lens(br)
                    ll, dl = lns[:hl], lns[hl:]
                stats["gap_blocks"] += 1
                end_bit = gap_to_eob(br.bit_position(), ll, dl)
                br = BitReader(data, end_bit)
            else:
                ll = lens[si, :hlit[si]]
                dl = lens[si, hlit[si]:hlit[si] + hdist[si]]
                done = False
                end_bit = None
                # last verified true-chain position (start of block)
                true_pos = int(symb[si])
                gapping = False  # a dead junction awaits a host join
                for l in range(int(seg_first[si]), int(seg_last[si])):
                    f = int(meta.flags[l])
                    if f & F_SKIP:
                        continue
                    if f & F_MERGED:
                        if gapping:
                            # host-join the junction: walk the true
                            # chain to this lane's handoff and verify
                            # the landing is exact
                            stats["joins"] += 1
                            landed, eob, eb = gap_join(
                                true_pos, int(meta.handoff[l]), ll, dl)
                            if eob:
                                done = True
                                end_bit = eb
                                break
                            if not landed:
                                # speculative chain was wrong past the
                                # junction: rest of block sequential
                                done = True
                                end_bit = gap_to_eob(eb, ll, dl)
                                break
                            gapping = False
                        stats["spliced"] += 1
                        a, b = int(meta.off[l]), \
                            int(meta.off[l]) + int(meta.nv[l])
                        if b > a:
                            emit_dev(l, a, b)
                        true_pos = int(meta.exits[l])
                        if f & F_EOB:
                            done = True
                            end_bit = true_pos
                            break
                    else:  # dead junction: join at the next merge
                        gapping = True
                if not done:
                    # block continues past the segment (false candidate
                    # ahead, capped coverage, or trailing dead lanes):
                    # finish it sequentially from the last true position
                    end_bit = gap_to_eob(true_pos, ll, dl)
                br = BitReader(data, end_bit)
        end_block()
        if bfinal:
            break
    return br.bit_position()


def _unpack_tokens(toks: np.ndarray):
    """compact int32 tokens -> (out_len, dist, root_val) int32."""
    ln = toks & 0x1FF
    field = toks >> 9
    is_lit = ln == 1
    di = np.where(is_lit, 0, field + 1).astype(np.int32)
    rv = np.where(is_lit, field, 0).astype(np.int32)
    return ln.astype(np.int32), di, rv


def _new_stats():
    return {"scan_ms": 0.0, "kernel_ms": 0.0, "fetch_ms": 0.0,
            "walk_ms": 0.0, "fetches": 0, "candidates": 0,
            "blocks": 0, "spliced": 0, "gap_blocks": 0, "gap_syms": 0,
            "joins": 0, "token_d2h_bytes": 0}


def _scan_and_launch(data: bytes, chunk_bits: int, stats):
    """Shared front half: stage the payload, scan headers, plan, launch.
    Returns (scan, plan, flat_d, data32) or None when the scanner found
    no dynamic-block candidates (caller falls back)."""
    from ..native import loader as NL
    from . import speculative as SP

    nbits = len(data) * 8
    t0 = time.perf_counter()
    # start the payload upload first: the device_put returns before the
    # transfer completes, so it overlaps the host header scan
    data32 = SP.stage_stream_device(data)
    scan = NL.scan_headers(data)
    stats["scan_ms"] = (time.perf_counter() - t0) * 1e3
    stats["candidates"] = len(scan[0])
    if len(scan[0]) == 0:
        return None, None, None, data32
    plan = _build_plan(nbits, scan, chunk_bits)
    t0 = time.perf_counter()
    flat_d = _launch(data32, plan, nbits)
    stats["kernel_ms"] = (time.perf_counter() - t0) * 1e3
    return scan, plan, flat_d, data32


def tokenize_stream_batched(data: bytes, window_len: int = 0,
                            chunk_bits: int = 8192,
                            collect_stats: bool = False):
    """Whole-stream batched speculative tokenize (see module docstring).

    Falls back to ops/speculative.tokenize_stream_speculative when the
    native scanner is unavailable or the stream has no dynamic-block
    candidates (the fallback uses its own per-block lane plan).
    Returns FrontendResult bit-identical to the other frontends, or
    (result, stats) when collect_stats.

    chunk_bits sets the lanes' nominal length; its default has not been
    tuned on a GPU."""
    from . import speculative as SP

    data = bytes(data)
    nbits = len(data) * 8
    try:
        from ..native import loader as NL
        native_ok = NL.available()
    except ImportError:
        native_ok = False
    if not native_ok or nbits >= (1 << 31):
        res = SP.tokenize_stream_speculative(
            data, window_len, collect_stats=collect_stats)
        return res

    stats = _new_stats()
    scan, plan, flat_d, data32 = _scan_and_launch(data, chunk_bits, stats)
    if scan is None:
        # no dynamic headers (stored/static-only stream): hand the
        # already-staged payload to the fallback so it is not re-uploaded
        res = SP.tokenize_stream_speculative(
            data, window_len, collect_stats=False, data32=data32)
        return (res, stats) if collect_stats else res

    # ONE bounded fetch: metadata + a token prefix sized by the
    # EXPECTED token count (see _build_plan); a stream denser than
    # expected pays a second fetch for the rest.
    hdr_len, bound = plan.hdr_len, plan.bound
    t0 = time.perf_counter()
    first = np.asarray(flat_d[:hdr_len + bound])
    stats["fetches"] = 1
    meta = _parse_meta(first[:hdr_len], plan)
    if meta.total > bound:
        tail = np.asarray(flat_d[hdr_len + bound:hdr_len + meta.total])
        compact = np.concatenate([first[hdr_len:], tail])
        stats["fetches"] = 2
    else:
        compact = first[hdr_len:hdr_len + meta.total]
    stats["fetch_ms"] = (time.perf_counter() - t0) * 1e3
    stats["token_d2h_bytes"] = 4 * (hdr_len + max(bound, meta.total))
    all_ol, all_di, all_rv = _unpack_tokens(compact)

    # --- host chain walk (shared, meta-only) + host splice emitters ----
    t0 = time.perf_counter()
    parts: list = []
    produced = 0
    pend: list = []  # buffered device ranges, flushed before host tokens

    def emit_block(ol, di, rv):
        """Per-block distance validation (mirrors speculative.py's
        deferred check; the reference checks inline,
        deflate.lisp:691) + append."""
        nonlocal produced
        if len(ol) == 0:
            return
        pref = np.cumsum(ol.astype(np.int64)) - ol
        bad = (di > pref + produced + window_len) & (di > 0)
        if np.any(bad):
            E.raise_for_code(E.ERR_BAD_DISTANCE)
        parts.append((ol, di, rv))
        produced += int(ol.sum())

    def flush():
        if pend:
            a = pend[0][0]
            b = pend[-1][1]
            emit_block(all_ol[a:b], all_di[a:b], all_rv[a:b])
            pend.clear()

    def emit_dev(l, a, b):
        # coalesce contiguous compact ranges into one emit_block call
        if pend and pend[-1][1] != a:
            flush()
        pend.append((a, b))

    def emit_host(ol, di, rv):
        flush()
        emit_block(ol, di, rv)

    end_bit = _walk(data, scan, plan, meta, stats, emit_dev, emit_host,
                    end_block=flush)
    flush()

    if parts:
        ol = np.concatenate([p[0] for p in parts])
        di = np.concatenate([p[1] for p in parts])
        rv = np.concatenate([p[2] for p in parts])
    else:
        ol = di = rv = np.zeros(0, np.int32)
    stats["walk_ms"] = (time.perf_counter() - t0) * 1e3
    tape = TokenTape(out_len=ol, dist=di, root_val=rv,
                     total_out=int(ol.sum()))
    res = FrontendResult(tape=tape, blocks=[],
                         end_bit=end_bit, finished=True)
    if collect_stats:
        return res, stats
    return res
