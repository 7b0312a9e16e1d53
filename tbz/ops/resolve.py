"""Device LZ77 resolver: token tape -> output bytes.

The reference materializes bytes inside the sequential decode loop with an
offset-specialized overlapped copy (deflate.lisp:244-359). On the
device that dependency chain is re-expressed data-parallel:

  1. exclusive prefix-sum of token lengths -> each token's output span;
  2. scatter + cumsum -> covering token id for every output byte;
  3. every byte gets a *parent* pointer: q - dist for match bytes
     (self for literal/stored roots), in a coordinate space with the
     32KB carry window prepended so back-references cross call
     boundaries (the window-carry semantics of deflate.lisp:121-137);
  4. pointer-doubling (P <- P[P]) until fixpoint — overlapping copies of
     any depth resolve in O(log depth) full-array gathers;
  5. one value gather from the root bytes.

Overlap semantics need no special cases here: a match byte's parent may
itself be a match byte of the same token; doubling converges to the
originating literal exactly as the reference's byte-serial copy would.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from . import gather as G
from ..tape import STORED_FLAG, TokenTape

W = C.MAX_WINDOW  # 32768


def _resolve_core(out_len: jnp.ndarray, dist: jnp.ndarray,
                  root_val: jnp.ndarray, n_tokens: jnp.ndarray,
                  input_bytes: jnp.ndarray, window: jnp.ndarray,
                  out_capacity: int, has_stored: bool = True
                  ) -> jnp.ndarray:
    """Traceable resolver body shared by `_resolve_impl` and the fused
    splice+resolve kernel (ops/fused.py). Returns uint8[W + out_capacity];
    real output is [W : W + total_out]. Leading W bytes are the (possibly
    zero) history window. Token arrays may be padded past n_tokens.
    has_stored=False (static) elides the stored-run input gather — a
    full-output-size gather — when the caller knows no token carries
    STORED_FLAG (e.g. the fused path's device tokens never do)."""
    T = out_len.shape[0]
    tok_idx = jnp.arange(T, dtype=jnp.int32)
    valid = tok_idx < n_tokens
    lens = jnp.where(valid, out_len, 0)
    starts = jnp.cumsum(lens, dtype=jnp.int32) - lens  # exclusive scan

    # Covering token id per output byte.
    scat_idx = jnp.where(valid, starts, out_capacity)  # invalid -> dropped
    marks = jnp.zeros(out_capacity, jnp.int32).at[scat_idx].add(
        1, mode="drop")
    tid = jnp.cumsum(marks) - 1                        # int32[out_capacity]
    tid = jnp.clip(tid, 0, T - 1)

    q = jnp.arange(out_capacity, dtype=jnp.int32)
    # ONE row gather for the three per-token fields, rows padded to
    # width 8
    z = jnp.zeros_like(dist)
    tok_rows = jnp.stack([dist, root_val, starts, z, z, z, z, z], axis=1)
    g = G.take(tok_rows, tid)
    d = g[:, 0]
    rv = g[:, 1]
    tstart = g[:, 2]

    # Root byte values: literal byte, or stored-run byte gathered from the
    # compressed input (stored blocks are raw copies, deflate.lisp:532-573).
    if has_stored:
        is_stored = (rv & STORED_FLAG) != 0
        stored_off = (rv & (STORED_FLAG - 1)) + (q - tstart)
        stored_byte = G.take(input_bytes, stored_off)
        root_byte = jnp.where(is_stored, stored_byte,
                              rv.astype(jnp.uint8))
    else:
        root_byte = rv.astype(jnp.uint8)

    # Combined coordinates: [0, W) = window, [W, W+out_capacity) = output.
    # Match-byte parents jump DIRECTLY to the token's source region:
    # byte j of a match with distance d copies from tstart - d + (j % d)
    # (identical to q - d when the copy doesn't self-overlap, and the
    # whole overlapped run in one hop when it does). This collapses
    # intra-token chains — an RLE-style dist=1 run is depth-1 instead of
    # depth-len — so doubling passes scale with the TOKEN genealogy
    # depth only (measured: ~halves the pass count on text).
    qc = q + W
    dd = jnp.maximum(d, 1)
    parent_out = jnp.where(d > 0, tstart - d + (q - tstart) % dd + W, qc)
    parent = jnp.concatenate([jnp.arange(W, dtype=jnp.int32), parent_out])
    parent = jnp.clip(parent, 0, W + out_capacity - 1)

    def cond(state):
        p, changed = state
        return changed

    def body(state):
        p, _ = state
        p2 = G.take(p, p)
        return p2, jnp.any(p2 != p)

    parent, _ = jax.lax.while_loop(cond, body, (parent, jnp.bool_(True)))

    values = jnp.concatenate([window, root_byte])
    return G.take(values, parent)


@functools.partial(jax.jit,
                   static_argnames=("out_capacity", "has_stored"))
def _resolve_impl(out_len: jnp.ndarray, dist: jnp.ndarray,
                  root_val: jnp.ndarray, n_tokens: jnp.ndarray,
                  total_out: jnp.ndarray, input_bytes: jnp.ndarray,
                  window: jnp.ndarray, out_capacity: int,
                  has_stored: bool = True) -> jnp.ndarray:
    return _resolve_core(out_len, dist, root_val, n_tokens, input_bytes,
                         window, out_capacity, has_stored)


def _pad_pow2(n: int, floor: int = 1024) -> int:
    n = max(n, floor)
    return 1 << (n - 1).bit_length()


def resolve_device(tape: TokenTape, input_bytes: bytes | np.ndarray,
                   window: bytes | np.ndarray = b"",
                   out_capacity: int | None = None):
    """Host wrapper: pads to power-of-two shape classes (bounding jit
    recompiles), runs the resolver, returns (device uint8[cap+W] full
    buffer, total_out). Callers slice [W : W+total_out].
    """
    n = len(tape)
    T = _pad_pow2(n)
    ol = np.zeros(T, np.int32)
    di = np.zeros(T, np.int32)
    rv = np.zeros(T, np.int32)
    ol[:n] = tape.out_len
    di[:n] = tape.dist
    rv[:n] = tape.root_val
    # floor 4096 keeps the buffer aligned for the tail checksum kernels
    cap = out_capacity or _pad_pow2(tape.total_out, floor=4096)
    assert tape.total_out <= cap
    inp = np.frombuffer(bytes(input_bytes), np.uint8) if not isinstance(
        input_bytes, np.ndarray) else input_bytes
    if inp.size == 0:
        inp = np.zeros(1, np.uint8)
    win = np.frombuffer(bytes(window), np.uint8) if not isinstance(
        window, np.ndarray) else window
    win = win[-W:]
    wpad = np.zeros(W, np.uint8)
    if len(win):
        wpad[W - len(win):] = win
    has_stored = bool(np.any(rv & STORED_FLAG))
    out = _resolve_impl(jnp.asarray(ol), jnp.asarray(di), jnp.asarray(rv),
                        np.int32(n), np.int32(tape.total_out),
                        jnp.asarray(inp), jnp.asarray(wpad), cap,
                        has_stored)
    return out, tape.total_out


def resolve_bytes(tape: TokenTape, input_bytes, window: bytes = b"") -> bytes:
    """Convenience: resolve and fetch to host bytes."""
    out, total = resolve_device(tape, input_bytes, window)
    return bytes(np.asarray(out[W:W + total]))
