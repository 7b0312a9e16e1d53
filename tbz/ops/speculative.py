"""Speculative multi-lane in-block decode (prototype of the north-star
kernel; cf. the parallel-inflate literature in PAPERS.md — rapidgzip /
"Massively-Parallel Lossless Data Decompression").

One Huffman block's symbol stream is sequential at bit level, but the
code is self-synchronizing: a decoder started at a WRONG bit offset
almost always converges onto the true symbol boundaries within a few
symbols. So:

  1. L lanes decode speculatively from evenly spaced bit offsets
     (lane 0 at the true block start), all in lockstep vector steps —
     one `lax.while_loop` whose body decodes one symbol on EVERY lane
     (flat-table gathers, vectorized over lanes).
  2. Each lane records its visited symbol-start positions and tokens.
  3. Stitching (host, cheap): the true entry of chunk l+1 is the first
     visited position >= that chunk's start in the TRUE decode of chunk
     l; if that position appears in lane l+1's visited set, lane l+1's
     tokens from that index on are exact. Unsynced lanes fall back to
     sequential decode — correctness never depends on synchronization.

Distance validation is deferred to stitch time (speculative lanes don't
know how much output precedes them).

This is the correctness substrate; ops/batched.py moves stitching
on-device and adds block-header speculation.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from .. import errors as E
from ..tape import TokenTape
from .tokenize_device import (_entry_consts, _peek, build_flat_table,
                              _e_nbits, _e_op, _e_extra, _e_val)

MAX_ENTRY_DRIFT = 48  # a symbol spans < 48 bits; true chunk entry is
                      # within this window past the chunk start


@functools.partial(jax.jit, static_argnames=("L", "max_syms"))
def _lanes_fused(data32, lit_pad, dist_pad, lit_c, dist_c, lane_starts,
                 lane_ends, total_bits, L: int, max_syms: int):
    """Table build + lane decode in ONE device call: the two table error
    codes ride at the END of the single flat result, so each DEFLATE
    block costs one device round trip, not two."""
    lit_tab, err = build_flat_table(lit_pad, lit_c, 288, True)
    dist_tab, err2 = build_flat_table(dist_pad, dist_c, 32, True)
    flat = _lanes_decode(data32, lit_tab, dist_tab, lane_starts,
                         lane_ends, total_bits, L, max_syms)
    return jnp.concatenate([flat, jnp.stack([err, err2])])


@functools.partial(jax.jit, static_argnames=("L", "max_syms"))
def _lanes_decode(data32, lit_tab, dist_tab, lane_starts, lane_ends,
                  total_bits, L: int, max_syms: int):
    """Decode up to max_syms symbols per lane, each lane stopping once
    its bit position passes its lane_end (or EOB / invalid / stream end).

    A fixed-length lax.scan with STACKED per-step outputs — a lane's
    emitted steps are a prefix (active is monotone), so the stacked
    arrays are row-compact with no in-loop scatters (an earlier
    while_loop + at[].set formulation spent ~all its time scattering).

    Returns per-lane arrays:
      starts   (L, max_syms) int32  symbol start bit positions (-1 pad)
      out_len  (L, max_syms) int32
      dist     (L, max_syms) int32  (-1 marks end-of-block token)
      rv       (L, max_syms) int32
      n_syms   (L,) int32
      ok       (L,) bool   lane ended cleanly (not invalid/underrun)
      exits    (L,) int32  bit position after the lane's last symbol
    """
    peek_v = jax.vmap(lambda p: _peek(data32, p, 15))
    peek13 = jax.vmap(lambda p: _peek(data32, p, 13))

    def step(carry, _):
        bit, active, bad = carry
        e = lit_tab[peek_v(bit).astype(jnp.int32)]
        nb = _e_nbits(e)
        op = _e_op(e)
        ex = _e_extra(e)
        p1 = bit + nb
        ebits = peek13(p1).astype(jnp.int32) & (
            (1 << jnp.clip(ex, 0, 13)) - 1)
        length = _e_val(e) + ebits
        p2 = p1 + jnp.where(op == C.OP_MATCH, ex, 0)
        de = dist_tab[peek_v(p2).astype(jnp.int32)]
        dnb = _e_nbits(de)
        p3 = p2 + jnp.where(op == C.OP_MATCH, dnb, 0)
        dex = _e_extra(de)
        debits = peek13(p3).astype(jnp.int32) & (
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
        # pack (out_len 9b | rv 8b | eob 1b) into one word: the stacked
        # lane arrays are the D2H payload
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
        step, init, None, length=max_syms)
    starts = starts.T
    packed = packed.T
    dist = dist.T
    n = jnp.sum(starts >= 0, axis=1).astype(jnp.int32)
    # ONE flat return value: everything comes back in one D2H
    return jnp.concatenate([
        starts.ravel(), packed.ravel(), dist.ravel(),
        n, (~bad).astype(jnp.int32), exit_bit])


def _lanes_decode_unpack(flat: np.ndarray, L: int, max_syms: int):
    q = L * max_syms
    starts = flat[:q].reshape(L, max_syms)
    packed = flat[q:2 * q].reshape(L, max_syms)
    dist = flat[2 * q:3 * q].reshape(L, max_syms)
    out_len = packed & 0x1FF
    rv = (packed >> 9) & 0xFF
    dist = np.where((packed >> 17) & 1, -1, dist)  # -1 marks EOB tokens
    n = flat[3 * q:3 * q + L]
    ok = flat[3 * q + L:3 * q + 2 * L].astype(bool)
    exits = flat[3 * q + 2 * L:3 * q + 3 * L]
    return starts, out_len, dist, rv, n, ok, exits


def stage_stream_device(data: bytes):
    """Upload a payload once for all of its blocks' lane decodes (the
    per-block re-upload was most of the stream's H2D traffic)."""
    # +16: 4 zero words of slack so the batched kernel's 3-word-row view
    # (rows[i] = words i..i+2) is in-bounds for any reachable bit pos
    pad = -(-len(data) // 4) * 4 + 16
    buf = np.zeros(pad, np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    return jnp.asarray(buf.view("<u4"))


def tokenize_block_speculative(data: bytes, start_bit: int,
                               lit_lens: np.ndarray,
                               dist_lens: np.ndarray,
                               chunk_bits: int = 2048,
                               produced_before: int = 0,
                               window_len: int = 0,
                               data32=None, span_hint: int = 0):
    """Speculatively decode one block's symbol stream (tables known,
    from `start_bit` up to its end-of-block).

    Returns (TokenTape, end_bit, stats) where stats reports lane
    synchronization. Falls back to sequential decode for any unsynced
    span, so the result is always exact (verified vs the oracle in
    tests). data32: device payload from stage_stream_device (uploaded
    here when absent).
    """
    from .. import huffman
    lit_lens = np.asarray(lit_lens, np.int64)
    dist_lens = np.asarray(dist_lens, np.int64)
    # host tables first: raises proper DeflateErrors on bad code sets
    lit2 = huffman.build_decode_table_checked(lit_lens, huffman.KIND_LITLEN)
    dist2 = huffman.build_decode_table_checked(dist_lens, huffman.KIND_DIST)
    lit_pad = np.zeros(288, np.int64)
    lit_pad[:len(lit_lens)] = lit_lens
    dist_pad = np.zeros(32, np.int64)
    dist_pad[:len(dist_lens)] = dist_lens
    lit_c, dist_c, _ = (jnp.asarray(x) for x in _entry_consts())

    nbits = len(data) * 8
    if data32 is None:
        data32 = stage_stream_device(data)

    span = nbits - start_bit
    if span_hint:
        # lanes past the block's EOB decode other blocks' bits with the
        # wrong tables — pure waste in kernel time AND fetch bytes, so
        # cap coverage near the (EWMA-estimated) block length; the tail
        # past the cap falls to the next call's sequential entry only
        # if the estimate was short, which the stitcher handles anyway
        span = min(span, max(span_hint, 4 * chunk_bits))
    L = max(1, min(256, span // chunk_bits))
    L = 1 << (L - 1).bit_length()  # pow2: one compile per shape class
    # Symbols are >= ~3 bits in real codes; a lane that exceeds the cap
    # (degenerate 1-2 bit codes) is simply marked unusable and its chunk
    # falls back to the sequential stitcher — exactness is unaffected.
    # Keeping the cap tight matters: the lane arrays are the D2H payload
    # (~6 bits/sym is the realistic floor; 16/3 keeps headroom while
    # cutting the padded fetch 25% vs chunk_bits/4).
    max_syms = max(256, chunk_bits * 3 // 16)
    lane_starts = np.array(
        [min(start_bit + l * chunk_bits, nbits) for l in range(L)],
        np.int32)
    lane_ends = np.minimum(lane_starts + chunk_bits, nbits).astype(np.int32)

    # ONE device call + ONE fetch per block: fused table build + lanes
    flat = np.asarray(_lanes_fused(
        data32, jnp.asarray(lit_pad), jnp.asarray(dist_pad), lit_c,
        dist_c, jnp.asarray(lane_starts), jnp.asarray(lane_ends),
        np.int32(nbits), L, max_syms))
    errs = flat[-2:]
    if int(errs[0]) != 0 or int(errs[1]) != 0:
        # host build_decode_table_checked validated the same code set
        # above, so a device table error means frontend disagreement —
        # raise (never assert: reachable from corrupt input under -O)
        E.raise_for_code(int(errs[0]) or int(errs[1]))
    starts, out_len, dist, rv, n_syms, ok, exits = _lanes_decode_unpack(
        flat[:-2], L, max_syms)

    # Sequential decoder shares lit2/dist2 (fallback + EOB finisher).
    from ..bitreader import BitReader
    from .. import reference as R

    def seq_decode(bit):
        br = BitReader(data, bit)
        ol, di, rvv = [], [], []
        while True:
            op, extra, val = R._decode_symbol(br, lit2, huffman.KIND_LITLEN)
            if op == C.OP_END:
                return (np.array(ol, np.int32), np.array(di, np.int32),
                        np.array(rvv, np.int32), br.bit_position())
            if op == C.OP_LITERAL:
                ol.append(1)
                di.append(0)
                rvv.append(val)
            else:
                length = val + (br.bits(extra) if extra else 0)
                _, dex, dval = R._decode_symbol(br, dist2, huffman.KIND_DIST)
                d = dval + (br.bits(dex) if dex else 0)
                ol.append(length)
                di.append(d)
                rvv.append(0)

    def decode_one(br):
        """(kind, out_len, dist, rv): kind 0=lit/match, 1=EOB."""
        op, extra, val = R._decode_symbol(br, lit2, huffman.KIND_LITLEN)
        if op == C.OP_END:
            return 1, 0, 0, 0
        if op == C.OP_LITERAL:
            return 0, 1, 0, val
        length = val + (br.bits(extra) if extra else 0)
        _, dex, dval = R._decode_symbol(br, dist2, huffman.KIND_DIST)
        d = dval + (br.bits(dex) if dex else 0)
        return 0, length, d, 0

    try:
        from ..native import loader as _nl
        use_native = _nl.available()
    except ImportError:
        use_native = False
    _empty = np.empty(0, np.int32)

    toks_ol: list = []
    toks_di: list = []
    toks_rv: list = []
    synced = 0
    fallbacks = 0
    gap_syms = 0
    entry = start_bit
    hit_eob = False
    eob_consumed = False  # native gap decode consumes the EOB symbol
    for l in range(L):
        if entry >= int(lane_ends[l]) or hit_eob:
            continue  # a previous gap decode already covered this chunk
        row_n = int(n_syms[l])
        row_starts = starts[l, :row_n]
        # a lane that filled its tape may have stopped mid-chunk; its
        # visited set is still usable for merging, but only if it ended
        # cleanly AND actually reached its lane end
        usable = bool(ok[l]) and (row_n < max_syms
                                  or int(exits[l]) >= int(lane_ends[l]))
        # Gap decode: walk the TRUE chain from `entry` until it lands on
        # a position this lane visited (self-synchronization merge), or
        # past the lane (chunk stays sequential).
        merge = None
        if usable:
            pos = int(np.searchsorted(row_starts, entry))
            if pos < row_n and row_starts[pos] == entry:
                merge = pos
        if merge is None:
            if use_native:
                g_ol, g_di, g_rv, entry2, midx, g_eob = _nl.gap_decode(
                    data, entry, lit_lens, dist_lens,
                    row_starts if usable else _empty, int(lane_ends[l]))
                gap_syms += len(g_ol)
                if len(g_ol):
                    toks_ol.append(g_ol)
                    toks_di.append(g_di)
                    toks_rv.append(g_rv)
                if g_eob:
                    hit_eob = True
                    eob_consumed = True
                    entry = entry2  # already past the EOB symbol
                    continue
                if midx >= 0:
                    merge = midx
                else:
                    entry = entry2
                    fallbacks += 1
                    continue
            else:
                br = BitReader(data, entry)
                g_ol, g_di, g_rv = [], [], []
                while True:
                    p = br.bit_position()
                    if usable:
                        pos = int(np.searchsorted(row_starts, p))
                        if pos < row_n and row_starts[pos] == p:
                            merge = pos
                            break
                    if p >= int(lane_ends[l]):
                        entry = p
                        break
                    kind, tl, td, tr = decode_one(br)
                    gap_syms += 1
                    if kind == 1:
                        hit_eob = True
                        entry = p  # EOB start; sequential tail finishes
                        break
                    g_ol.append(tl)
                    g_di.append(td)
                    g_rv.append(tr)
                if g_ol:
                    toks_ol.append(np.array(g_ol, np.int32))
                    toks_di.append(np.array(g_di, np.int32))
                    toks_rv.append(np.array(g_rv, np.int32))
                if merge is None:
                    fallbacks += 1
                    continue  # next lane stitches from the updated entry
        synced += 1
        seg_d = dist[l, merge:row_n]
        eob_rel = np.nonzero(seg_d == -1)[0]
        if eob_rel.size:
            j = merge + int(eob_rel[0])
            toks_ol.append(out_len[l, merge:j])
            toks_di.append(dist[l, merge:j])
            toks_rv.append(rv[l, merge:j])
            entry = int(starts[l, j])  # EOB symbol start; tail decodes it
            hit_eob = True
            continue
        toks_ol.append(out_len[l, merge:row_n])
        toks_di.append(dist[l, merge:row_n])
        toks_rv.append(rv[l, merge:row_n])
        entry = int(exits[l])

    if eob_consumed:
        ol2 = di2 = rv2 = _empty
        end_bit = entry
    elif use_native:
        ol2, di2, rv2, end_bit, _, tail_eob = _nl.gap_decode(
            data, entry, lit_lens, dist_lens, _empty, 1 << 62)
        if not tail_eob:
            # reachable with truncated input under `python -O` (asserts
            # stripped): surface the proper error class, never a
            # silently short tape
            raise E.TruncatedError(
                "block symbol stream ended before its end-of-block code")
    else:
        ol2, di2, rv2, end_bit = seq_decode(entry)
    ol = np.concatenate(toks_ol + [ol2]) if toks_ol else ol2
    di = np.concatenate(toks_di + [di2]) if toks_di else di2
    rvv = np.concatenate(toks_rv + [rv2]) if toks_rv else rv2

    # Deferred distance validation (speculative lanes cannot know the
    # produced prefix; the reference checks inline, deflate.lisp:691).
    produced = np.cumsum(ol.astype(np.int64)) - ol
    bad = di > (produced + produced_before + window_len)
    if np.any(bad & (di > 0)):
        E.raise_for_code(E.ERR_BAD_DISTANCE)

    tape = TokenTape(out_len=ol.astype(np.int32), dist=di.astype(np.int32),
                     root_val=rvv.astype(np.int32), total_out=int(ol.sum()))
    stats = {"lanes": L, "synced": synced, "fallbacks": fallbacks,
             "gap_syms": gap_syms,
             "sync_rate": synced / L if L else 1.0, "hit_eob": hit_eob}
    return tape, end_bit, stats


def tokenize_stream_speculative(data: bytes, window_len: int = 0,
                                chunk_bits: int = 2048,
                                collect_stats: bool = False,
                                data32=None):
    """Whole-stream speculative tokenize: the production integration of
    the multi-lane decoder (ROADMAP §2 (b)). Block headers are parsed
    sequentially on the host (a few hundred bytes per ~50KB block); each
    static/dynamic block's SYMBOL STREAM — where all the bits are —
    decodes on the device with speculative lockstep lanes; stored blocks
    are emitted directly. Exactness never depends on lane sync (unsynced
    spans fall back to sequential decode inside the stitcher).

    Returns a FrontendResult bit-identical to the other frontends
    (tests/test_three_way.py), or (result, stats) when collect_stats."""
    from ..bitreader import BitReader
    from ..errors import DeflateError, ERR_BAD_BLOCK_TYPE, \
        ERR_STORED_LEN_MISMATCH
    from ..tape import STORED_FLAG, FrontendResult
    from .. import reference as R

    data = bytes(data)
    br = BitReader(data, 0)
    parts: list = []
    produced = 0
    all_stats: list = []
    # data32: payload already staged by a caller (e.g. the batched
    # tier falling back after a no-candidate scan, which would otherwise
    # upload the stream twice); else uploaded on the first compressed
    # block and reused
    block_bits_ewma = 0  # running block-length estimate (lane coverage)
    while True:
        bfinal = bool(br.bits(1))
        btype = br.bits(2)
        if btype == C.BTYPE_RESERVED:
            raise DeflateError("invalid block type 3", ERR_BAD_BLOCK_TYPE)
        if btype == C.BTYPE_STORED:
            br.align_to_byte()
            ln = br.bits(16)
            nlen = br.bits(16)
            if ln != (~nlen & 0xFFFF):
                raise DeflateError("stored LEN/NLEN mismatch",
                                   ERR_STORED_LEN_MISMATCH)
            if ln:
                off = br.bit_position() >> 3
                br.read_bytes_aligned(ln)
                parts.append((np.array([ln], np.int32),
                              np.array([0], np.int32),
                              np.array([STORED_FLAG | off], np.int32)))
                produced += ln
        else:
            if btype == C.BTYPE_STATIC:
                lit_lens = C.FIXED_LITLEN_LENGTHS
                dist_lens = C.FIXED_DIST_LENGTHS
            else:
                lens, hlit, hdist = R._read_dynamic_lens(br)
                lit_lens = lens[:hlit]
                dist_lens = lens[hlit:]
            if data32 is None:
                data32 = stage_stream_device(data)
            b0 = br.bit_position()
            tape, end_bit, stats = tokenize_block_speculative(
                data, b0, lit_lens, dist_lens,
                chunk_bits=chunk_bits, produced_before=0,
                window_len=produced + window_len, data32=data32,
                span_hint=int(block_bits_ewma * 3) // 2)
            block_bits_ewma = (end_bit - b0 if block_bits_ewma == 0 else
                               (block_bits_ewma + (end_bit - b0)) // 2)
            all_stats.append(stats)
            if len(tape):
                parts.append((tape.out_len, tape.dist, tape.root_val))
                produced += tape.total_out
            br = BitReader(data, end_bit)
        if bfinal:
            break
    if parts:
        ol = np.concatenate([p[0] for p in parts])
        di = np.concatenate([p[1] for p in parts])
        rv = np.concatenate([p[2] for p in parts])
    else:
        ol = di = rv = np.zeros(0, np.int32)
    tape = TokenTape(out_len=ol, dist=di, root_val=rv,
                     total_out=int(ol.sum()))
    res = FrontendResult(tape=tape, blocks=[],
                         end_bit=br.bit_position(), finished=True)
    if collect_stats:
        agg = {
            "blocks": len(all_stats),
            "lanes": sum(s["lanes"] for s in all_stats),
            "synced": sum(s["synced"] for s in all_stats),
            "gap_syms": sum(s["gap_syms"] for s in all_stats),
        }
        return res, agg
    return res
