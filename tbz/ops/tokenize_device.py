"""All-device DEFLATE tokenizer (pure XLA, jittable).

The sequential bit-stream walk of the reference's engine
(deflate.lisp:92-730) expressed as a lax.while_loop state machine whose
per-symbol step is pure vector math + gathers:

  - Huffman tables are built ON DEVICE from code lengths, vectorized:
    canonical codes via sort + cumsum, then a FLAT 2^15-entry decode
    table filled with ONE searchsorted over the canonical interval
    starts (code << (15-len) is ascending in canonical order), replacing
    the reference's two-level fill loop (huffman-tree.lisp:186-217).
  - Decode is one gather per symbol from the flat table.
  - Block state machine = lax.switch over modes; the dynamic-header
    code-length loop runs inside the same while_loop.

One symbol per iteration: this is the *correctness* device path and the
substrate for the round-2 speculative multi-lane decoder (the same step
vmapped over lanes with resynchronization — SURVEY §5.7). Throughput is
loop-bound; the production path uses the native frontend meanwhile.

Error semantics mirror ../reference.py exactly (shared error codes).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from .. import errors as E
from . import gather as G
from ..tape import STORED_FLAG, FrontendResult, TokenTape

# --- packed flat-table entries (nbits 0:4 | op 4:7 | extra 7:12 | val 16:32)
_INVALID = np.uint32(C.INVALID_ENTRY)

# Modes of the decode state machine.
M_BLOCK = 0      # read BFINAL/BTYPE
M_STORED = 1     # emit stored-run token
M_DATA = 2       # decode one litlen symbol (+match)
M_DHT_SIZES = 3  # read HLIT/HDIST/HCLEN
M_DHT_CLLEN = 4  # read one 3-bit code-length-code length
M_DHT_BUILD_CL = 5
M_DHT_LENS = 6   # decode one code-length symbol (with repeats)
M_DHT_BUILD = 7
M_DONE = 8
M_ERR = 9

_MAX_LENS = 320


@functools.lru_cache(maxsize=None)
def _rev15_np() -> np.ndarray:
    v = np.arange(1 << 15, dtype=np.int32)
    r = np.zeros(1 << 15, dtype=np.int32)
    for i in range(15):
        r |= ((v >> i) & 1) << (14 - i)
    return r


@functools.lru_cache(maxsize=None)
def _entry_consts() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-symbol packed entries sans nbits: (litlen[288], dist[32], cl[19])."""
    lit = np.zeros(288, np.uint32)
    for s in range(288):
        if s < 256:
            lit[s] = C.pack_entry(C.OP_LITERAL, 0, 0, s)
        elif s == 256:
            lit[s] = C.pack_entry(C.OP_END, 0, 0, 0)
        elif s <= 285:
            i = s - 257
            lit[s] = C.pack_entry(C.OP_MATCH, 0, int(C.LENGTH_EXTRA[i]),
                                  int(C.LENGTH_BASE[i]))
        else:
            lit[s] = C.pack_entry(C.OP_INVALID, 0, 0, 0)
    dist = np.zeros(32, np.uint32)
    for s in range(32):
        if s <= 29:
            dist[s] = C.pack_entry(C.OP_MATCH, 0, int(C.DIST_EXTRA[s]),
                                   int(C.DIST_BASE[s]))
        else:
            dist[s] = C.pack_entry(C.OP_INVALID, 0, 0, 0)
    cl = np.array([C.pack_entry(C.OP_LITERAL, 0, 0, s) for s in range(19)],
                  np.uint32)
    return lit, dist, cl


def build_flat_table(lens: jnp.ndarray, entry_const: jnp.ndarray,
                     n_syms: int, allow_single: bool):
    """Vectorized flat 2^15 decode table from per-symbol lengths.

    lens: int32[n_syms] (0 = unused). Returns (table uint32[2^15], err).
    allow_single: zlib's single-1-bit-code incompleteness exception.
    """
    lens = lens.astype(jnp.int32)
    syms = jnp.arange(n_syms, dtype=jnp.int32)
    used = lens > 0
    n_used = jnp.sum(used.astype(jnp.int32))

    counts = jnp.zeros(16, jnp.int32).at[jnp.clip(lens, 0, 15)].add(
        jnp.where(used, 1, 0))
    kraft = jnp.sum(counts[1:] * (1 << (15 - jnp.arange(1, 16))))
    over = kraft > (1 << 15)
    max_len = jnp.max(jnp.where(used, lens, 0))
    incomplete_ok = allow_single & (max_len == 1) & (n_used == 1)
    incomplete_bad = (kraft < (1 << 15)) & (n_used > 0) & ~incomplete_ok
    err = jnp.where(over | incomplete_bad,
                    jnp.int32(E.ERR_BAD_HUFFMAN), jnp.int32(E.OK))

    # Canonical order: sort by (len, sym); unused last.
    key = jnp.where(used, lens * 512 + syms, 1 << 20)
    order = jnp.argsort(key)
    idx0 = jnp.arange(n_syms, dtype=jnp.int32)
    # Sentinel 16 for unused tail keeps the array sorted downstream.
    lens_s = jnp.where(idx0 < n_used, lens[order], 16)
    # first code per length, closed form (the textbook recurrence
    # next_code[l] = (next_code[l-1]+counts[l-1])<<1 unrolls to a
    # prefix sum of counts[j] << (15-j), rescaled — a fori_loop of 14
    # tiny sequential steps is disproportionately slow inside the
    # vmapped build):  next_code[l] = sum_{j<l} counts[j]*2^{l-j}
    lvl = jnp.arange(16, dtype=jnp.int32)
    weighted = counts << (15 - lvl)
    prefix = jnp.cumsum(weighted) - weighted  # exclusive
    next_code = prefix >> (15 - lvl)
    # rank within same length: index of each run's first element via a
    # running max over run starts (lens_s is sorted)
    idx = jnp.arange(n_syms, dtype=jnp.int32)
    is_first = jnp.concatenate([jnp.array([True]),
                                lens_s[1:] != lens_s[:-1]])
    first_of_len = jax.lax.cummax(jnp.where(is_first, idx, 0))
    codes_s = next_code[jnp.clip(lens_s, 0, 15)] + (idx - first_of_len)
    starts = jnp.where(idx < n_used,
                       codes_s << (15 - jnp.clip(lens_s, 1, 15)),
                       jnp.int32(1 << 15))
    span = 1 << (15 - jnp.clip(lens_s, 1, 15))

    # Slot -> canonical rank WITHOUT searchsorted: used entries'
    # starts are strictly increasing and tile the canonical space, so a
    # scatter of 1s at the starts + cumsum IS the rank; the bit-reversed
    # slot order is one permutation gather at the end.
    limit = starts + span  # end of each entry's canonical span
    entries_sorted = (entry_const[
        jnp.clip(order, 0, entry_const.shape[0] - 1)]
        | lens_s.astype(jnp.uint32))
    # Slot values and validity WITHOUT any 2^15-wide gather: entry
    # values are a per-rank step function over slots, so scatter
    # per-rank DELTAS at the span starts and cumsum (uint32
    # wraparound makes delta+cumsum exact); validity is span coverage,
    # a +1/-1 scatter at start/limit cumsummed (gap slots of incomplete
    # codes net to 0; limit==2^15 drops off the end harmlessly).
    e_prev = jnp.concatenate([jnp.zeros(1, entries_sorted.dtype),
                              entries_sorted[:-1]])
    delta = entries_sorted - e_prev
    entry_cum = jnp.cumsum(
        jnp.zeros(1 << 15, entries_sorted.dtype)
        .at[starts].add(delta, mode="drop"))
    cover = jnp.cumsum(
        jnp.zeros(1 << 15, jnp.int32)
        .at[starts].add(1, mode="drop")
        .at[jnp.where(idx < n_used, limit, 1 << 15)].add(-1, mode="drop"))
    tbl_canon = jnp.where(cover > 0, entry_cum, jnp.asarray(_INVALID))
    table = G.take(tbl_canon, jnp.asarray(_rev15_np()))
    return table, err


def _peek(data32: jnp.ndarray, bit_pos: jnp.ndarray, n: int) -> jnp.ndarray:
    """Peek up to 32 bits LSB-first at bit_pos (zero-padded past end)."""
    wi = (bit_pos >> 5).astype(jnp.int32)
    off = (bit_pos & 31).astype(jnp.uint32)
    w0 = data32[wi]
    w1 = data32[wi + 1]
    lo = w0 >> off
    hi = jnp.where(off > 0, w1 << ((32 - off) & 31), jnp.uint32(0))
    return (lo | hi) & jnp.uint32((1 << n) - 1)


def _e_nbits(e): return (e & 0xF).astype(jnp.int32)
def _e_op(e): return ((e >> C.ENTRY_OP_SHIFT) & 0x7).astype(jnp.int32)
def _e_extra(e): return ((e >> C.ENTRY_EXTRA_SHIFT) & 0x1F).astype(jnp.int32)
def _e_val(e): return (e >> C.ENTRY_VAL_SHIFT).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("T",))
def tokenize_device_impl(data32: jnp.ndarray, total_bits: jnp.ndarray,
                         window_len: jnp.ndarray, T: int):
    """Returns (out_len, dist, root_val, n_tok, produced, end_bit, err,
    finished). data32: little-endian uint32 view, >= 2 words of slack."""
    lit_c, dist_c, cl_c = (jnp.asarray(x) for x in _entry_consts())
    zero_tab = jnp.zeros(1 << 15, jnp.uint32)

    st = dict(
        bit_pos=jnp.int32(0),
        mode=jnp.int32(M_BLOCK),
        bfinal=jnp.int32(0),
        produced=jnp.int32(0),
        n_tok=jnp.int32(0),
        err=jnp.int32(E.OK),
        finished=jnp.int32(0),
        out_len=jnp.zeros(T, jnp.int32),
        dist=jnp.zeros(T, jnp.int32),
        root_val=jnp.zeros(T, jnp.int32),
        lit_tab=zero_tab,
        dist_tab=zero_tab,
        cl_tab=zero_tab,
        hlit=jnp.int32(0), hdist=jnp.int32(0), hclen=jnp.int32(0),
        cl_i=jnp.int32(0),
        lens=jnp.zeros(_MAX_LENS, jnp.int32),
        lens_i=jnp.int32(0),
        stored_len=jnp.int32(0),
    )
    keys = list(st.keys())

    def pack(d): return tuple(d[k] for k in keys)
    def unpack(t): return dict(zip(keys, t))

    def set_err(s, code):
        s = dict(s)
        s["err"] = jnp.int32(code)
        s["mode"] = jnp.int32(M_ERR)
        return s

    def emit(s, length, d, rv):
        s = dict(s)
        full = s["n_tok"] >= T
        s["out_len"] = s["out_len"].at[jnp.minimum(s["n_tok"], T - 1)].set(
            jnp.where(full, s["out_len"][T - 1], length))
        s["dist"] = s["dist"].at[jnp.minimum(s["n_tok"], T - 1)].set(
            jnp.where(full, s["dist"][T - 1], d))
        s["root_val"] = s["root_val"].at[jnp.minimum(s["n_tok"], T - 1)].set(
            jnp.where(full, s["root_val"][T - 1], rv))
        s["n_tok"] = s["n_tok"] + jnp.where(full, 0, 1)
        s["produced"] = s["produced"] + jnp.where(full, 0, length)
        s["err"] = jnp.where(full, jnp.int32(E.ERR_TAPE_OVERFLOW), s["err"])
        return s, full

    # --- mode handlers (each: state-dict -> state-dict) --------------------

    def h_block(s):
        s = dict(s)
        ok = s["bit_pos"] + 3 <= total_bits
        hdr = _peek(data32, s["bit_pos"], 3)
        bfinal = (hdr & 1).astype(jnp.int32)
        btype = (hdr >> 1).astype(jnp.int32)
        s["bfinal"] = jnp.where(ok, bfinal, s["bfinal"])

        def stored_case(s):
            s = dict(s)
            pos = (s["bit_pos"] + 3 + 7) & ~jnp.int32(7)
            ok2 = pos + 32 <= total_bits
            ln = _peek(data32, pos, 16).astype(jnp.int32)
            nlen = _peek(data32, pos + 16, 16).astype(jnp.int32)
            good = ln == (~nlen & 0xFFFF)
            have = pos + 32 + ln * 8 <= total_bits
            s["bit_pos"] = pos + 32
            s["stored_len"] = ln
            # Order matters (zlib parity): header-truncation, then
            # LEN/NLEN validity, THEN payload availability.
            s["mode"] = jnp.where(
                ~ok2, jnp.int32(M_ERR),
                jnp.where(~good, jnp.int32(M_ERR),
                          jnp.where(~have, jnp.int32(M_ERR),
                                    jnp.int32(M_STORED))))
            s["err"] = jnp.where(
                ~ok2, jnp.int32(E.ERR_TRUNCATED),
                jnp.where(~good, jnp.int32(E.ERR_STORED_LEN_MISMATCH),
                          jnp.where(~have, jnp.int32(E.ERR_TRUNCATED),
                                    s["err"])))
            return s

        def static_case(s):
            s = dict(s)
            lit_lens = jnp.asarray(C.FIXED_LITLEN_LENGTHS)
            dist_lens = jnp.asarray(C.FIXED_DIST_LENGTHS)
            lt, e1 = build_flat_table(lit_lens, lit_c, 288, True)
            dt, e2 = build_flat_table(dist_lens, dist_c, 32, True)
            s["lit_tab"] = lt
            s["dist_tab"] = dt
            s["bit_pos"] = s["bit_pos"] + 3
            s["mode"] = jnp.int32(M_DATA)
            return s

        def dyn_case(s):
            s = dict(s)
            s["bit_pos"] = s["bit_pos"] + 3
            s["mode"] = jnp.int32(M_DHT_SIZES)
            return s

        def bad_case(s):
            return set_err(s, E.ERR_BAD_BLOCK_TYPE)

        s2 = jax.lax.switch(jnp.clip(btype, 0, 3),
                            [stored_case, static_case, dyn_case, bad_case],
                            s)
        s2 = dict(s2)
        s2["mode"] = jnp.where(ok, s2["mode"], jnp.int32(M_ERR))
        s2["err"] = jnp.where(ok, s2["err"], jnp.int32(E.ERR_TRUNCATED))
        s2["bit_pos"] = jnp.where(ok, s2["bit_pos"], s["bit_pos"])
        return s2

    def h_stored(s):
        s = dict(s)
        off = (s["bit_pos"] >> 3)

        def do_emit(s):
            s2, _ = emit(s, s["stored_len"], jnp.int32(0),
                         STORED_FLAG | off)
            return s2

        s = jax.lax.cond(s["stored_len"] > 0, do_emit, lambda x: dict(x), s)
        s = dict(s)
        s["bit_pos"] = s["bit_pos"] + s["stored_len"] * 8
        s["mode"] = jnp.where(s["bfinal"] == 1, jnp.int32(M_DONE),
                              jnp.int32(M_BLOCK))
        s["finished"] = jnp.where(s["bfinal"] == 1, 1, s["finished"])
        return s

    def decode_one(s, tab):
        """Decode a symbol from a flat table; returns (e, nbits, ok)."""
        bits = _peek(data32, s["bit_pos"], 15)
        e = tab[bits.astype(jnp.int32)]
        nb = _e_nbits(e)
        ok = s["bit_pos"] + nb <= total_bits
        return e, nb, ok

    def h_data(s):
        s = dict(s)
        e, nb, ok = decode_one(s, s["lit_tab"])
        op = _e_op(e)
        invalid = op == C.OP_INVALID

        def lit_case(s):
            s = dict(s)
            s2, _ = emit(s, jnp.int32(1), jnp.int32(0), _e_val(e))
            s2["bit_pos"] = s["bit_pos"] + nb
            return s2

        def end_case(s):
            s = dict(s)
            s["bit_pos"] = s["bit_pos"] + nb
            s["mode"] = jnp.where(s["bfinal"] == 1, jnp.int32(M_DONE),
                                  jnp.int32(M_BLOCK))
            s["finished"] = jnp.where(s["bfinal"] == 1, 1, s["finished"])
            return s

        def match_case(s):
            s = dict(s)
            p1 = s["bit_pos"] + nb
            ex = _e_extra(e)
            ebits = _peek(data32, p1, 13).astype(jnp.int32) & \
                ((1 << jnp.clip(ex, 0, 13)) - 1)
            length = _e_val(e) + ebits
            p2 = p1 + ex
            de = s["dist_tab"][_peek(data32, p2, 15).astype(jnp.int32)]
            dnb = _e_nbits(de)
            p3 = p2 + dnb
            dex = _e_extra(de)
            debits = _peek(data32, p3, 13).astype(jnp.int32) & \
                ((1 << jnp.clip(dex, 0, 13)) - 1)
            d = _e_val(de) + debits
            p4 = p3 + dex
            ok2 = p4 <= total_bits
            dinvalid = _e_op(de) != C.OP_MATCH
            toofar = d > s["produced"] + window_len
            s2, _ = emit(s, length, d, jnp.int32(0))
            s2 = dict(s2)
            s2["bit_pos"] = p4
            bad = ~ok2 | dinvalid | toofar
            s2["mode"] = jnp.where(bad, jnp.int32(M_ERR), s2["mode"])
            s2["err"] = jnp.where(
                ~ok2, jnp.int32(E.ERR_TRUNCATED),
                jnp.where(dinvalid, jnp.int32(E.ERR_INVALID_CODE),
                          jnp.where(toofar, jnp.int32(E.ERR_BAD_DISTANCE),
                                    s2["err"])))
            # do not count the token if bad
            return s2

        branch = jnp.where(invalid, 3,
                           jnp.where(op == C.OP_LITERAL, 0,
                                     jnp.where(op == C.OP_END, 1, 2)))

        def inv_case(s):
            return set_err(s, E.ERR_INVALID_CODE)

        s2 = jax.lax.switch(branch, [lit_case, end_case, match_case,
                                     inv_case], s)
        s2 = dict(s2)
        # truncation beats invalid when fewer bits than the code needs
        s2["mode"] = jnp.where(ok, s2["mode"], jnp.int32(M_ERR))
        s2["err"] = jnp.where(ok, s2["err"], jnp.int32(E.ERR_TRUNCATED))
        return s2

    def h_dht_sizes(s):
        s = dict(s)
        ok = s["bit_pos"] + 14 <= total_bits
        v = _peek(data32, s["bit_pos"], 14).astype(jnp.int32)
        hlit = (v & 31) + 257
        hdist = ((v >> 5) & 31) + 1
        hclen = ((v >> 10) & 15) + 4
        bad = (hlit > 286) | (hdist > 30)
        s["hlit"] = hlit
        s["hdist"] = hdist
        s["hclen"] = hclen
        s["bit_pos"] = jnp.where(ok, s["bit_pos"] + 14, s["bit_pos"])
        s["cl_i"] = jnp.int32(0)
        s["lens"] = jnp.zeros(_MAX_LENS, jnp.int32)
        s["lens_i"] = jnp.int32(0)
        s["mode"] = jnp.where(
            ~ok, jnp.int32(M_ERR),
            jnp.where(bad, jnp.int32(M_ERR), jnp.int32(M_DHT_CLLEN)))
        s["err"] = jnp.where(
            ~ok, jnp.int32(E.ERR_TRUNCATED),
            jnp.where(bad, jnp.int32(E.ERR_TOO_MANY_SYMBOLS), s["err"]))
        # reuse lens[:19] slot storage for cl lens? keep separate: store
        # cl lens into lens array tail region [300:319].
        return s

    def h_dht_cllen(s):
        s = dict(s)
        ok = s["bit_pos"] + 3 <= total_bits
        v = _peek(data32, s["bit_pos"], 3).astype(jnp.int32)
        order = jnp.asarray(C.CODE_LENGTH_ORDER)
        slot = 300 + order[jnp.minimum(s["cl_i"], 18)]
        s["lens"] = s["lens"].at[slot].set(jnp.where(ok, v, 0))
        s["bit_pos"] = jnp.where(ok, s["bit_pos"] + 3, s["bit_pos"])
        s["cl_i"] = s["cl_i"] + 1
        done = s["cl_i"] >= s["hclen"]
        s["mode"] = jnp.where(
            ~ok, jnp.int32(M_ERR),
            jnp.where(done, jnp.int32(M_DHT_BUILD_CL),
                      jnp.int32(M_DHT_CLLEN)))
        s["err"] = jnp.where(~ok, jnp.int32(E.ERR_TRUNCATED), s["err"])
        return s

    def h_dht_build_cl(s):
        s = dict(s)
        cl_lens = jax.lax.dynamic_slice(s["lens"], (300,), (19,))
        tab, err = build_flat_table(cl_lens, cl_c, 19, False)
        s["cl_tab"] = tab
        s["mode"] = jnp.where(err != E.OK, jnp.int32(M_ERR),
                              jnp.int32(M_DHT_LENS))
        s["err"] = jnp.where(err != E.OK, err, s["err"])
        # zero the scratch region so litlen/dist lens are clean
        idx = jnp.arange(_MAX_LENS)
        s["lens"] = jnp.where(idx >= 300, 0, s["lens"])
        return s

    def h_dht_lens(s):
        s = dict(s)
        e, nb, ok = decode_one(s, s["cl_tab"])
        sym = _e_val(e)
        invalid = _e_op(e) == C.OP_INVALID
        total = s["hlit"] + s["hdist"]
        i = s["lens_i"]
        idx = jnp.arange(_MAX_LENS, dtype=jnp.int32)
        p1 = s["bit_pos"] + nb

        # literal length (<16)
        lit_lens = s["lens"].at[jnp.minimum(i, _MAX_LENS - 1)].set(
            jnp.where(sym < 16, sym, s["lens"][jnp.minimum(i, _MAX_LENS - 1)]))

        # repeats
        is16 = sym == 16
        is17 = sym == 17
        rep_bits = jnp.where(is16, 2, jnp.where(is17, 3, 7))
        rb = _peek(data32, p1, 7).astype(jnp.int32) & ((1 << rep_bits) - 1)
        rep = jnp.where(is16, 3 + rb, jnp.where(is17, 3 + rb, 11 + rb))
        prev = s["lens"][jnp.maximum(i - 1, 0)]
        rep_val = jnp.where(is16, prev, 0)
        no_prev = is16 & (i == 0)
        overrun = (sym >= 16) & (i + rep > total)
        rep_lens = jnp.where((idx >= i) & (idx < i + rep), rep_val,
                             s["lens"])

        use_rep = sym >= 16
        new_lens = jnp.where(use_rep, rep_lens, lit_lens)
        consumed = nb + jnp.where(use_rep, rep_bits, 0)
        ok2 = s["bit_pos"] + consumed <= total_bits
        new_i = i + jnp.where(use_rep, rep, 1)

        s["lens"] = jnp.where(ok & ok2 & ~invalid & ~no_prev & ~overrun,
                              new_lens, s["lens"])
        s["lens_i"] = jnp.where(ok & ok2 & ~invalid & ~no_prev & ~overrun,
                                new_i, s["lens_i"])
        s["bit_pos"] = jnp.where(ok & ok2 & ~invalid & ~no_prev & ~overrun,
                                 s["bit_pos"] + consumed, s["bit_pos"])
        bad_lit_overflow = (sym < 16) & (i >= total)
        any_bad = invalid | no_prev | overrun | bad_lit_overflow
        finished_lens = s["lens_i"] >= total
        s["mode"] = jnp.where(
            ~(ok & ok2), jnp.int32(M_ERR),
            jnp.where(any_bad, jnp.int32(M_ERR),
                      jnp.where(finished_lens, jnp.int32(M_DHT_BUILD),
                                jnp.int32(M_DHT_LENS))))
        s["err"] = jnp.where(
            ~(ok & ok2), jnp.int32(E.ERR_TRUNCATED),
            jnp.where(invalid, jnp.int32(E.ERR_INVALID_CODE),
                      jnp.where(no_prev | overrun,
                                jnp.int32(E.ERR_BAD_CL_REPEAT),
                                jnp.where(bad_lit_overflow,
                                          jnp.int32(E.ERR_BAD_CL_REPEAT),
                                          s["err"]))))
        return s

    def h_dht_build(s):
        s = dict(s)
        idx = jnp.arange(_MAX_LENS, dtype=jnp.int32)
        lit_lens = jnp.where(idx < s["hlit"], s["lens"], 0)[:288]
        # dist lens: lens[hlit : hlit+hdist] -> gather with shifted index
        dl = s["lens"][jnp.clip(idx[:32] + s["hlit"], 0, _MAX_LENS - 1)]
        dist_lens = jnp.where(idx[:32] < s["hdist"], dl, 0)
        missing_eob = s["lens"][256] == 0
        lt, e1 = build_flat_table(lit_lens, lit_c, 288, True)
        dt, e2 = build_flat_table(dist_lens, dist_c, 32, True)
        s["lit_tab"] = lt
        s["dist_tab"] = dt
        err = jnp.where(missing_eob, jnp.int32(E.ERR_BAD_HUFFMAN),
                        jnp.where(e1 != E.OK, e1, e2))
        s["mode"] = jnp.where(err != E.OK, jnp.int32(M_ERR),
                              jnp.int32(M_DATA))
        s["err"] = jnp.where(err != E.OK, err, s["err"])
        return s

    def h_done(s):
        return dict(s)

    def h_err(s):
        return dict(s)

    handlers = [h_block, h_stored, h_data, h_dht_sizes, h_dht_cllen,
                h_dht_build_cl, h_dht_lens, h_dht_build, h_done, h_err]

    def cond(t):
        s = unpack(t)
        return ((s["mode"] != M_DONE) & (s["mode"] != M_ERR)
                & (s["err"] == E.OK))

    def body(t):
        s = unpack(t)
        s2 = jax.lax.switch(s["mode"], [lambda x, h=h: h(x)
                                        for h in handlers], s)
        return pack(s2)

    final = unpack(jax.lax.while_loop(cond, body, pack(st)))
    return (final["out_len"], final["dist"], final["root_val"],
            final["n_tok"], final["produced"], final["bit_pos"],
            final["err"], final["finished"])


#: streams at/above this size route through the speculative multi-lane
#: decoder (per-launch lane setup amortizes; below it the sequential
#: while_loop machine wins on latency)
SPECULATIVE_MIN_BYTES = 1 << 16


def tokenize_auto(data: bytes, window_len: int = 0) -> FrontendResult:
    """Device-frontend dispatcher (the 'device' option of
    frontend.tokenize): large streams decode speculatively — batched
    (all blocks in one device call, ops/batched) when the native header
    scanner is available, per-block lockstep lanes (ops/speculative)
    otherwise; small ones use the one-symbol-per-iteration while_loop
    machine."""
    if len(data) >= SPECULATIVE_MIN_BYTES:
        from .batched import tokenize_stream_batched
        return tokenize_stream_batched(bytes(data), window_len)
    return tokenize_device(data, window_len)


def tokenize_device(data: bytes, window_len: int = 0,
                    T: int | None = None) -> FrontendResult:
    """Host wrapper with the frontend contract (raises on errors)."""
    data = bytes(data)
    nbits = len(data) * 8
    pad = -(-len(data) // 4) * 4 + 8
    buf = np.zeros(pad, np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    data32 = jnp.asarray(buf.view("<u4"))
    # ~1 token/byte covers real streams; the RFC-hard bound is 8
    # tokens/byte (a 1-bit literal code). On overflow jump STRAIGHT to
    # the hard bound — exactly one retry at one deterministic shape
    # class (a x4 escalation would compile several intermediate shapes).
    hard_T = 1 << max(10, (8 * len(data) + 16).bit_length())
    if T is None:
        T = 1 << max(10, (len(data)).bit_length())
    (out_len, dist, root_val, n_tok, produced, end_bit, err,
     finished) = tokenize_device_impl(data32, np.int32(nbits),
                                      np.int32(window_len), T)
    err = int(err)
    if err == E.ERR_TAPE_OVERFLOW:
        assert T < hard_T, "tape overflow at the RFC-hard token bound"
        return tokenize_device(data, window_len, hard_T)
    if err == E.ERR_TRUNCATED:
        from ..errors import TruncatedError
        raise TruncatedError("input underrun")
    E.raise_for_code(err)
    n = int(n_tok)
    tape = TokenTape(out_len=np.asarray(out_len[:n]),
                     dist=np.asarray(dist[:n]),
                     root_val=np.asarray(root_val[:n]),
                     total_out=int(produced))
    return FrontendResult(tape=tape, blocks=[], end_bit=int(end_bit),
                          finished=bool(int(finished)))
