"""Device LZ77 span resolver (flat form).

Resolution is one row fetch per span, scheduled on the host:

  - the C++ planner (frontend.cc tbz_plan_spans_flat) pre-fills literal
    and stored bytes straight into the output buffer on the host (they
    never enter the kernel), decomposes overlap copies into doubling
    pieces, flattens copy genealogies with a window-limited source
    redirect, chops spans at 128B boundaries of both src and dst, and
    list-schedules them into dependency-safe (G row-groups x K slots)
    batches grouped into seg_rows segments;
  - the device table IS the output array (256 window rows prepended,
    global row coordinates); per slot the kernel does ONE single-row
    frame fetch, an in-register barrel rotate, a byte mask, a dense
    K-reduction per group, and one scatter-add per batch into a small
    segment accumulator.

The pointer-doubling resolver (ops/resolve.py) computes the same bytes
with no host planner; the span resolver serves frontend='device' and
streams the fused route does not take (api._decode_body). The
scan/global-scatter variants below are kept as cross-checked
formulation baselines (tests/test_resolve_flat.py).

Semantics matched: deflate.lisp:244-359 (overlap/offset<8 copies via
the doubling decomposition), :121-137 (32KB window carry — here the
window rows prepended to the table).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

W_ROWS = 256  # 32KB window, prepended to the output table as rows


# --- flat resolver -----------------------------------------------------------
# Literals are host-prefilled into the output (never enter the kernel),
# the carried table IS the output array (256 window rows prepended,
# global row coords), and spans are chopped at src AND dst 128B rows so
# each slot is ONE single-row frame fetch. Per step: gather, pad, 8
# barrel selects, mask, K-reduce, scatter-add.


def _barrel_contrib(frame, a, o, ln, G, K, lane128):
    """Shared slot pipeline: rotate each (B, 32)-u32 128-byte frame left
    by (a-o)&127, mask to [o, o+ln), reduce the K slots of each group.
    Valid because the planner never lets a span straddle its source row
    (a+len <= 128), so the rotate's wrap never lands inside the mask.
    5 word stages + 2 byte-in-word stages; the round-3a shift
    formulation needed 8 stages on 64 lanes (2.3x the vector traffic)."""
    B = frame.shape[0]
    t = (a - o) & 127
    q = t >> 2
    r = t & 3
    x = frame
    for k in range(5):
        sh = 1 << k
        rolled = jnp.concatenate([x[:, sh:], x[:, :sh]], axis=1)
        bit = ((q >> k) & 1).astype(bool)[:, None]
        x = jnp.where(bit, rolled, x)
    for k in range(2):
        sb = 8 << k
        nxt = jnp.concatenate([x[:, 1:], x[:, :1]], axis=1)
        shifted = (jax.lax.shift_right_logical(x, jnp.uint32(sb))
                   | (nxt << jnp.uint32(32 - sb)))
        bit = ((r >> k) & 1).astype(bool)[:, None]
        x = jnp.where(bit, shifted, x)
    mask8 = jnp.where((lane128 >= o[:, None])
                      & (lane128 < (o + ln)[:, None]),
                      jnp.uint8(0xFF), jnp.uint8(0))
    mask = jax.lax.bitcast_convert_type(
        mask8.reshape(B, 32, 4), jnp.uint32)
    x = x & mask
    return x.reshape(G, K, 32).sum(axis=1, dtype=jnp.uint32)  # (G, 32)


@functools.partial(jax.jit, static_argnames=("n_rows_out", "seg_rows"))
def _resolve_flat_scan_impl(srcaddr, lenoff, g_rows, b_segrow, out0,
                            window_rows, n_rows_out: int, seg_rows: int):
    """Scan-over-batches variant: per batch, gather frames from the full
    table, scatter-add the group contributions into a seg_rows dynamic
    slice at the batch's segment row (batches are segment-pure). The
    round-3 A/B baseline for _resolve_flat_impl."""
    NB, G, K = srcaddr.shape
    B = G * K
    table0 = jnp.concatenate([window_rows, out0], axis=0)
    lane128 = jax.lax.broadcasted_iota(jnp.int32, (1, 128), 1)

    def step(table, xs):
        sa, lo_, gr, segrow = xs
        sa = sa.reshape(B)
        lo_f = lo_.reshape(B).astype(jnp.int32)
        u = sa >> 7
        a = sa & 127
        o = jax.lax.shift_right_logical(lo_f, 8) & 127
        ln = lo_f & 255
        contrib = _barrel_contrib(table[u], a, o, ln, G, K, lane128)
        seg = jax.lax.dynamic_slice(table, (segrow, 0), (seg_rows, 32))
        seg = seg.at[gr].add(contrib)
        return jax.lax.dynamic_update_slice(table, seg, (segrow, 0)), None

    table, _ = jax.lax.scan(step, table0,
                            (srcaddr, lenoff, g_rows, b_segrow))
    return table[W_ROWS:]


@functools.partial(jax.jit, static_argnames=("n_rows_out",))
def _resolve_flat_gscat_impl(srcaddr, lenoff, g_rows_g, out0,
                             window_rows, n_rows_out: int):
    """Scan-over-batches with DIRECT global scatter (no slice/update):
    g_rows_g are absolute table rows. A/B variant: it scatters into the
    whole table but avoids the slice/update copies."""
    NB, G, K = srcaddr.shape
    B = G * K
    table0 = jnp.concatenate([window_rows, out0], axis=0)
    lane128 = jax.lax.broadcasted_iota(jnp.int32, (1, 128), 1)

    def step(table, xs):
        sa, lo_, gr = xs
        sa = sa.reshape(B)
        lo_f = lo_.reshape(B).astype(jnp.int32)
        u = sa >> 7
        a = sa & 127
        o = jax.lax.shift_right_logical(lo_f, 8) & 127
        ln = lo_f & 255
        contrib = _barrel_contrib(table[u], a, o, ln, G, K, lane128)
        return table.at[gr].add(contrib), None

    table, _ = jax.lax.scan(step, table0, (srcaddr, lenoff, g_rows_g))
    return table[W_ROWS:]


@functools.partial(jax.jit, static_argnames=("n_rows_out", "seg_rows"))
def _resolve_flat_impl(srcaddr, lenoff, g_rows, seg_lo, seg_hi, seg_base,
                       out0, window_rows, n_rows_out: int, seg_rows: int):
    """srcaddr (NB,G,K) int32 table byte address (= global src + 32768);
    lenoff (NB,G,K) int16 = dstoff<<8 | len; g_rows (NB,G) int32 target
    row RELATIVE to the batch's segment; seg_lo/seg_hi/seg_base (S,)
    int32 = each segment's [batch range) and base table row; out0
    (n_rows_out,32)/window_rows (256,32) uint32 word rows. Returns
    (n_rows_out, 32) uint32 resolved output rows.

    Nested-loop structure: row scatter into a small target is cheaper
    than into the whole table, and a per-batch dynamic slice/update of
    the table costs table-sized copies. So the OUTER fori walks segments and
    touches the table once per segment (slice + add + update), while
    the INNER fori walks the segment's batches with the table as a
    loop-INVARIANT gather source and scatter-adds into a small carried
    (seg_rows, 32) accumulator. Same-segment reads are served by
    table[u] + acc[u - base]: literal prefill lives in the table, match
    contributions in acc, and the two never overlap a byte. Batches
    outside every segment range (shape padding) never execute."""
    NB, G, K = srcaddr.shape
    B = G * K
    S = seg_base.shape[0]
    table0 = jnp.concatenate([window_rows, out0], axis=0)
    lane128 = jax.lax.broadcasted_iota(jnp.int32, (1, 128), 1)

    def seg_body(s, table):
        base = seg_base[s]

        def batch_body(b, acc):
            sa = jax.lax.dynamic_slice(srcaddr, (b, 0, 0),
                                       (1, G, K)).reshape(B)
            lo_f = jax.lax.dynamic_slice(lenoff, (b, 0, 0),
                                         (1, G, K)).reshape(B)
            lo_f = lo_f.astype(jnp.int32)
            gr = jax.lax.dynamic_slice(g_rows, (b, 0), (1, G)).reshape(G)
            u = sa >> 7
            a = sa & 127
            o = jax.lax.shift_right_logical(lo_f, 8) & 127
            ln = lo_f & 255

            frame = table[u]                            # (B, 32) u32
            rel = u - base
            in_seg = (rel >= 0) & (rel < seg_rows)
            facc = acc[jnp.clip(rel, 0, seg_rows - 1)]
            frame = frame + jnp.where(in_seg[:, None], facc,
                                      jnp.uint32(0))
            contrib = _barrel_contrib(frame, a, o, ln, G, K, lane128)
            return acc.at[gr].add(contrib)

        acc0 = jnp.zeros((seg_rows, 32), jnp.uint32)
        acc = jax.lax.fori_loop(seg_lo[s], seg_hi[s], batch_body, acc0)
        seg = jax.lax.dynamic_slice(table, (base, 0), (seg_rows, 32))
        return jax.lax.dynamic_update_slice(table, seg + acc, (base, 0))

    table = jax.lax.fori_loop(0, S, seg_body, table0)
    return table[W_ROWS:]


def stage_flat_plan(plan, window: bytes = b""):
    """Stage a host FlatPlan into the padded argument tuple for
    _resolve_flat_impl. Returns (args, n_rows_out)."""
    NB = max(plan.n_batches, 1)
    NB_pad = _pad_batches(NB, floor=4)
    G, K = plan.G, plan.K
    srcaddr = np.zeros((NB_pad, G, K), np.int32)
    lenoff = np.zeros((NB_pad, G, K), np.int16)
    g_rows = np.zeros((NB_pad, G), np.int32)
    if plan.n_batches:
        srcaddr[:NB] = plan.srcaddr.reshape(NB, G, K)
        lenoff[:NB] = plan.lenoff.reshape(NB, G, K)
        g_rows[:NB] = plan.g_row.reshape(NB, G)

    # segment table from the per-batch segment rows: runs of equal
    # b_segrow become [seg_lo, seg_hi) batch ranges. Shape-padded
    # entries get empty ranges — the kernel's inner loop never runs
    # them, so batch padding costs nothing on device.
    if plan.n_batches:
        bs = plan.b_segrow
        starts = np.flatnonzero(np.r_[True, bs[1:] != bs[:-1]])
        seg_base_v = bs[starts]
        seg_lo_v = starts
        seg_hi_v = np.r_[starts[1:], NB]
    else:
        seg_base_v = np.array([W_ROWS], np.int32)
        seg_lo_v = np.array([0], np.int32)
        seg_hi_v = np.array([0], np.int32)
    S = len(seg_base_v)
    S_pad = _pad_batches(S, floor=1)
    seg_base = np.full(S_pad, seg_base_v[-1], np.int32)
    seg_lo = np.full(S_pad, NB_pad, np.int32)
    seg_hi = np.full(S_pad, NB_pad, np.int32)
    seg_base[:S] = seg_base_v
    seg_lo[:S] = seg_lo_v
    seg_hi[:S] = seg_hi_v

    # pow2 >= seg_rows and a multiple of it: the last segment's dynamic
    # slice [segrow, segrow + seg_rows) always stays inside the table
    n_rows_out = _pow2(-(-max(plan.total_out, 1) // 128),
                       floor=plan.seg_rows)
    o8 = np.zeros(n_rows_out * 128, np.uint8)
    o8[:plan.out0.size] = plan.out0
    out0 = o8.view("<u4").reshape(n_rows_out, 32)

    w8 = np.zeros(W_ROWS * 128, np.uint8)
    if window:
        w = np.frombuffer(bytes(window)[-32768:], np.uint8)
        w8[32768 - len(w):] = w
    wrows = w8.view("<u4").reshape(W_ROWS, 32)
    return (srcaddr, lenoff, g_rows, seg_lo, seg_hi, seg_base, out0,
            wrows), n_rows_out


def resolve_flat_device(tape, input_bytes, window: bytes = b"",
                        G: int = 4096, K: int = 4, seg_rows: int = 16384):
    """Plan on host (C++ flat planner), resolve on device. Returns
    (device uint32 word rows, total_out)."""
    from ..native import loader
    plan = loader.plan_spans_flat(tape, input_bytes,
                                  window_len=len(window), G=G, K=K,
                                  seg_rows=seg_rows)
    args, n_rows_out = stage_flat_plan(plan, window)
    # ONE batched host->device transfer for the whole plan
    dargs = jax.device_put(tuple(args))
    rows = _resolve_flat_impl(*dargs, n_rows_out, plan.seg_rows)
    return rows, plan.total_out


def resolve_flat_bytes(tape, input_bytes, window: bytes = b"",
                       G: int = 4096, K: int = 4,
                       seg_rows: int = 16384) -> bytes:
    """Convenience: flat-resolve and fetch to host bytes."""
    rows, total = resolve_flat_device(tape, input_bytes, window, G=G, K=K,
                                      seg_rows=seg_rows)
    host = np.ascontiguousarray(np.asarray(rows))
    return bytes(host.view(np.uint8).reshape(-1)[:total])


def _pow2(n: int, floor: int = 1) -> int:
    n = max(n, floor)
    return 1 << (n - 1).bit_length()


def _pad_batches(n: int, floor: int = 16) -> int:
    """Batch-count shape ladder: pow2 AND 1.5*pow2 steps (max ~33%
    padding — padded batches run the full per-step kernel cost, so pow2
    alone wasted up to half the scan)."""
    n = max(n, floor)
    p = 1 << (n - 1).bit_length()
    if n <= p // 2 + p // 4:
        return p // 2 + p // 4
    return p
