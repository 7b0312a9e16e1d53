"""Adler-32 and CRC-32: host oracles, combine algebra, and vectorized
device (JAX) kernels.

The reference implements unrolled scalar loops with deferred modulo
(checksums.lisp:18-174) and a table-driven CRC (checksums.lisp:177-210).
The device kernels instead exploit that both checksums are *combinable*:

- Adler-32 over a concatenation follows from per-chunk (sum, weighted
  sum) pairs — computed as wide vector reductions, tree-combined with
  length-shifted merges (the math behind zlib's adler32_combine).
- CRC-32 is GF(2)-linear: per-lane table CRCs with zero init are merged
  by multiplying with x^(8·len) mod P, realized as constant 32x32 GF(2)
  matrices per tree level. Leading zeros are free in the zero-init
  linear form, so variable lengths are handled by front-padding.

Both device kernels take (padded_data, n) with real bytes right-aligned
so one jitted program serves every length up to the pad size.
"""

from __future__ import annotations

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np

ADLER_MOD = 65521
CRC_POLY = 0xEDB88320  # reflected

# --- host oracles ----------------------------------------------------------

adler32 = zlib.adler32
crc32 = zlib.crc32


# --- GF(2) algebra for CRC (host) ------------------------------------------

def _gf2_matrix_times(mat: list[int], vec: int) -> int:
    s = 0
    i = 0
    while vec:
        if vec & 1:
            s ^= mat[i]
        vec >>= 1
        i += 1
    return s


def _gf2_matrix_square(mat: list[int]) -> list[int]:
    return [_gf2_matrix_times(mat, m) for m in mat]


@functools.lru_cache(maxsize=None)
def _x8_matrix() -> tuple[int, ...]:
    """Matrix for multiplying by x^8 in the reflected CRC-32 domain."""
    # multiply-by-x matrix: column j -> x * x^j
    odd = [0] * 32
    odd[0] = CRC_POLY
    for i in range(1, 32):
        odd[i] = 1 << (i - 1)
    m = odd
    m = _gf2_matrix_square(m)  # x^2
    m = _gf2_matrix_square(m)  # x^4
    m = _gf2_matrix_square(m)  # x^8
    return tuple(m)


@functools.lru_cache(maxsize=None)
def _shift_matrix(nbytes: int) -> tuple[int, ...]:
    """Matrix for x^(8*nbytes) mod P (reflected domain)."""
    m = list(_x8_matrix())
    result = None
    n = nbytes
    while n:
        if n & 1:
            result = m if result is None else [
                _gf2_matrix_times(m, c) for c in result]
        n >>= 1
        m = _gf2_matrix_square(m)
    if result is None:  # nbytes == 0 -> identity
        return tuple(1 << i for i in range(32))
    return tuple(result)


def crc32_shift(crc: int, nbytes: int) -> int:
    """crc * x^(8*nbytes) mod P in the reflected domain."""
    return _gf2_matrix_times(list(_shift_matrix(nbytes)), crc)


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC of concat(A,B) from crc32(A), crc32(B), len(B) — the zlib
    crc32_combine identity, used for sharded/tree checksum merges."""
    if len2 == 0:
        return crc1
    # With crc(X) = ~(L(X) ^ ~0·x^{8|X|}), the init-conditioning terms
    # cancel by linearity and the combine reduces to a pure shift+xor.
    return crc32_shift(crc1, len2) ^ crc2


def adler32_combine(a1: int, a2: int, len2: int) -> int:
    """Adler-32 of concat from the two piece checksums (zlib semantics)."""
    rem = len2 % ADLER_MOD
    s1_1, s2_1 = a1 & 0xFFFF, (a1 >> 16) & 0xFFFF
    s1_2, s2_2 = a2 & 0xFFFF, (a2 >> 16) & 0xFFFF
    s1 = (s1_1 + s1_2 - 1) % ADLER_MOD
    s2 = (s2_1 + s2_2 + rem * (s1_1 - 1)) % ADLER_MOD
    return ((s2 % ADLER_MOD) << 16) | s1


# --- CRC tables ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def crc_table() -> np.ndarray:
    """The classic 256-entry table (reference: checksums.lisp:177-193)."""
    t = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (CRC_POLY if (c & 1) else 0)
        t[i] = c
    return t


def _cols_to_bitmat(cols: list[int]) -> np.ndarray:
    """Column-uint32 matrix -> (32,32) 0/1 int8 with out = (in @ M) & 1."""
    m = np.zeros((32, 32), dtype=np.int8)
    for j in range(32):
        for k in range(32):
            m[j, k] = (cols[j] >> k) & 1
    return m


@functools.lru_cache(maxsize=None)
def _shift_bitmat_np(nbytes: int) -> np.ndarray:
    return _cols_to_bitmat(list(_shift_matrix(nbytes)))


@functools.lru_cache(maxsize=None)
def _pow2_shift_bitmats() -> np.ndarray:
    """(35, 32, 32) int8 bit-matrices for x^(2^k), k in 0..34 — enough to
    shift by any bit count 8*n for n < 2^31, composed on device."""
    # x^(2^0) = x: the multiply-by-x matrix
    odd = [0] * 32
    odd[0] = CRC_POLY
    for i in range(1, 32):
        odd[i] = 1 << (i - 1)
    mats = [odd]
    m = odd
    for _ in range(34):
        m = _gf2_matrix_square(m)
        mats.append(m)
    return np.stack([_cols_to_bitmat(m) for m in mats])


# --- device helpers --------------------------------------------------------

_BIT_WEIGHTS = None


def _gf2_apply_device(mat_bits: jnp.ndarray, vec: jnp.ndarray) -> jnp.ndarray:
    """Apply a GF(2) 32x32 bit-matrix to uint32 vec(s) as an integer
    matmul + parity — one matrix product instead of 32 selects."""
    shape = vec.shape
    v = vec.reshape(-1, 1)
    bits = ((v >> jnp.arange(32, dtype=jnp.uint32)) & 1).astype(jnp.int32)
    out_bits = (bits @ mat_bits.astype(jnp.int32)) & 1
    weights = jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32)
    out = jnp.sum(out_bits.astype(jnp.uint32) * weights, axis=-1,
                  dtype=jnp.uint32)
    return out.reshape(shape)


def _crc_shift_dynamic_device(crc: jnp.ndarray, nbits: jnp.ndarray) -> jnp.ndarray:
    """crc * x^nbits with traced nbits, via square-and-multiply over the
    precomputed power matrices (a lax.scan of tiny GF(2) matmuls)."""
    mats = jnp.asarray(_pow2_shift_bitmats())
    ks = jnp.arange(35, dtype=jnp.uint32)

    def body(c, km):
        k, mat = km
        bit = ((nbits >> k) & 1).astype(bool)
        return jnp.where(bit, _gf2_apply_device(mat, c), c), None

    out, _ = jax.lax.scan(body, crc, (ks, mats))
    return out


def pad_front(data: np.ndarray, padded_len: int) -> np.ndarray:
    """Right-align `data` in a zero buffer of padded_len (host helper)."""
    out = np.zeros(padded_len, dtype=np.uint8)
    if len(data):
        out[padded_len - len(data):] = data
    return out


# --- device Adler-32 -------------------------------------------------------

ADLER_CHUNK = 4096  # max chunk so per-chunk weighted sum fits uint32


def adler32_device(data, n, prev=1, chunk: int = ADLER_CHUNK):
    """Adler-32 of the last `n` bytes of uint8 `data` (leading bytes are
    masked to zero), continuing from `prev`. len(data) must be a multiple
    of `chunk`. Returns uint32. (Wrapper casts host ints to uint32 so
    values >= 2^31 don't overflow jit's default int32 conversion.)"""
    return _adler32_device(data, np.uint32(n), np.uint32(prev), chunk)


@functools.partial(jax.jit, static_argnames=("chunk",))
def _adler32_device(data: jnp.ndarray, n: jnp.ndarray,
                    prev: jnp.ndarray, chunk: int) -> jnp.ndarray:
    N = data.shape[0]
    assert N % chunk == 0
    n = jnp.asarray(n, jnp.uint32)
    prev = jnp.asarray(prev, jnp.uint32)
    idx = jnp.arange(N, dtype=jnp.uint32)
    x = jnp.where(idx >= (N - n), data, 0).astype(jnp.uint32)
    K = N // chunk
    xc = x.reshape(K, chunk)
    w = jnp.arange(chunk, 0, -1, dtype=jnp.uint32)  # weight chunk..1
    sa = jnp.sum(xc, axis=1, dtype=jnp.uint32) % ADLER_MOD
    sb = jnp.sum(xc * w, axis=1, dtype=jnp.uint32) % ADLER_MOD

    # Tree combine; identity chunks (0,0) conceptually sit at the FRONT
    # (leading zeros are weightless), so pad K to a power of two in front.
    K2 = 1 << max(0, (K - 1).bit_length())
    if K2 != K:
        sa = jnp.concatenate([jnp.zeros(K2 - K, jnp.uint32), sa])
        sb = jnp.concatenate([jnp.zeros(K2 - K, jnp.uint32), sb])
    level_len = chunk
    while sa.shape[0] > 1:
        l2 = jnp.uint32(level_len % ADLER_MOD)
        sa_l, sa_r = sa[0::2], sa[1::2]
        sb_l, sb_r = sb[0::2], sb[1::2]
        sb = (sb_l + l2 * sa_l + sb_r) % ADLER_MOD
        sa = (sa_l + sa_r) % ADLER_MOD
        level_len *= 2
    sa, sb = sa[0], sb[0]

    # Fold in prev state: A=A0+sa, B=B0+n*A0+sb (mod m).
    a0 = prev & 0xFFFF
    b0 = (prev >> 16) & 0xFFFF
    a = (a0 + sa) % ADLER_MOD
    b = (b0 + (n % ADLER_MOD) * (a0 % ADLER_MOD) + sb) % ADLER_MOD
    return (b << 16) | a


# --- device CRC-32 ---------------------------------------------------------

CRC_LANE_BYTES = 128  # bytes per lane; lanes are tree-combined


@functools.lru_cache(maxsize=None)
def _lane_matrix_np(lane_bytes: int) -> np.ndarray:
    """(8*lane_bytes, 32) int8 GF(2) matrix mapping a lane's byte-bits to
    its zero-init linear CRC: row (8j+b) = x^(8(B-1-j)) * L(byte 1<<b).

    CRC is GF(2)-linear, so a whole lane's CRC is ONE bit-matrix matmul —
    a matrix-product formulation of the reference's byte-serial table
    loop (checksums.lisp:196-210). Operands are 0/1 and sums stay below
    2^11, so any integer or float lowering of the product is exact."""
    B = lane_bytes
    t = crc_table()
    rows = np.zeros((8 * B, 32), dtype=np.int8)
    for j in range(B):
        shift = list(_shift_matrix(B - 1 - j))
        for b in range(8):
            v = _gf2_matrix_times(shift, int(t[1 << b]))
            for k in range(32):
                rows[8 * j + b, k] = (v >> k) & 1
    return rows


def _lane_bits(x_masked: jnp.ndarray, lane_bytes: int) -> jnp.ndarray:
    """uint8[N] -> per-lane bit rows (K, 8*lane_bytes) int8."""
    K = x_masked.shape[0] // lane_bytes
    lane = x_masked.reshape(K, lane_bytes, 1)
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = (lane >> shifts) & 1
    return bits.reshape(K, 8 * lane_bytes).astype(jnp.int8)


def _crc_linear_from_masked(x_masked: jnp.ndarray,
                            lane_bytes: int) -> jnp.ndarray:
    """Zero-init linear CRC of the full (masked) padded array — all
    matmuls: one (K, 8B)@(8B, 32) per-lane pass, then log2(K) pairwise
    (K/2, 32)@(32, 32) tree levels. No gathers, no sequential loops."""
    K = x_masked.shape[0] // lane_bytes
    bits = _lane_bits(x_masked, lane_bytes)
    T = jnp.asarray(_lane_matrix_np(lane_bytes))
    regs = jnp.matmul(bits, T, preferred_element_type=jnp.int32) & 1
    regs = regs.astype(jnp.int8)  # (K, 32) bit rows
    K2 = 1 << max(0, (K - 1).bit_length())
    if K2 != K:  # identity lanes on the LEFT (leading zeros are free)
        regs = jnp.concatenate(
            [jnp.zeros((K2 - K, 32), jnp.int8), regs])
    level_bytes = lane_bytes
    while regs.shape[0] > 1:
        mat = jnp.asarray(_shift_bitmat_np(level_bytes))
        pairs = regs.reshape(-1, 2, 32)
        left = jnp.matmul(pairs[:, 0, :], mat,
                          preferred_element_type=jnp.int32)
        regs = ((left + pairs[:, 1, :]) & 1).astype(jnp.int8)
        level_bytes *= 2
    weights = jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(regs[0].astype(jnp.uint32) * weights, dtype=jnp.uint32)


def crc32_device(data, n, prev=0, lane_bytes: int = CRC_LANE_BYTES):
    """CRC-32 of the last `n` bytes of uint8 `data`, continuing from
    `prev`. len(data) must be a multiple of lane_bytes. Returns uint32.

    Math: reg(init=~prev, data) = L(data) ^ (~prev)·x^{8n}; crc = ~reg.
    L computed with the bit-matrix product scheme (front-padding is
    free).
    """
    return _crc32_device(data, np.uint32(n), np.uint32(prev), lane_bytes)


@functools.partial(jax.jit, static_argnames=("lane_bytes",))
def _crc32_device(data: jnp.ndarray, n: jnp.ndarray,
                  prev: jnp.ndarray, lane_bytes: int) -> jnp.ndarray:
    N = data.shape[0]
    assert N % lane_bytes == 0
    n = jnp.asarray(n, jnp.uint32)
    prev = jnp.asarray(prev, jnp.uint32)
    idx = jnp.arange(N, dtype=jnp.uint32)
    x = jnp.where(idx >= (N - n), data, 0)
    lin = _crc_linear_from_masked(x, lane_bytes)
    init = _crc_shift_dynamic_device(~prev & jnp.uint32(0xFFFFFFFF),
                                     jnp.uint32(8) * n)
    return (lin ^ init) ^ jnp.uint32(0xFFFFFFFF)


# --- tail variants: real bytes at the FRONT of the padded buffer -----------
# (the natural layout of resolver output). Trailing zeros are removed
# algebraically: Adler by weight correction, CRC by multiplying with
# x^(-8·pad) — the inverse shift matrix (x is invertible mod P).

def _gf2_bitmat_inverse(m: np.ndarray) -> np.ndarray:
    a = np.concatenate([m.astype(np.uint8),
                        np.eye(32, dtype=np.uint8)], axis=1)
    for col in range(32):
        piv = col + int(np.argmax(a[col:, col]))
        assert a[piv, col], "singular GF(2) matrix"
        a[[col, piv]] = a[[piv, col]]
        for r in range(32):
            if r != col and a[r, col]:
                a[r] ^= a[col]
    return a[:, 32:].astype(np.int8)


@functools.lru_cache(maxsize=None)
def _pow2_unshift_bitmats() -> np.ndarray:
    """(35,32,32) int8: matrices for x^(-2^k), k in 0..34."""
    inv1 = _gf2_bitmat_inverse(_cols_to_bitmat(
        [(CRC_POLY if i == 0 else 1 << (i - 1)) for i in range(32)]))
    mats = [inv1]
    m = inv1.astype(np.int64)
    for _ in range(34):
        m = (m @ m) % 2
        mats.append(m.astype(np.int8))
    return np.stack([x.astype(np.int8) for x in mats])


def _crc_unshift_dynamic_device(crc: jnp.ndarray,
                                nbits: jnp.ndarray) -> jnp.ndarray:
    mats = jnp.asarray(_pow2_unshift_bitmats())
    ks = jnp.arange(35, dtype=jnp.uint32)

    def body(c, km):
        k, mat = km
        bit = ((nbits >> k) & 1).astype(bool)
        return jnp.where(bit, _gf2_apply_device(mat, c), c), None

    out, _ = jax.lax.scan(body, crc, (ks, mats))
    return out


def _pad_to(data, multiple: int):
    """Zero-pad uint8 `data` to a multiple of `multiple` bytes (the tail
    kernels mask everything past n, so padding never changes a sum)."""
    pad = (-data.shape[0]) % multiple
    return jnp.pad(data, (0, pad)) if pad else data


def adler32_device_tail(data, n, prev=1, chunk: int = ADLER_CHUNK):
    """Adler-32 of the FIRST `n` bytes of uint8 `data` (trailing masked)."""
    return _adler32_device_tail(_pad_to(data, chunk), np.uint32(n),
                                np.uint32(prev), chunk)


@functools.partial(jax.jit, static_argnames=("chunk",))
def _adler32_device_tail(data, n, prev, chunk):
    N = data.shape[0]
    assert N % chunk == 0
    idx = jnp.arange(N, dtype=jnp.uint32)
    x = jnp.where(idx < n, data, 0).astype(jnp.uint32)
    K = N // chunk
    xc = x.reshape(K, chunk)
    w = jnp.arange(chunk, 0, -1, dtype=jnp.uint32)
    sa = jnp.sum(xc, axis=1, dtype=jnp.uint32) % ADLER_MOD
    sb = jnp.sum(xc * w, axis=1, dtype=jnp.uint32) % ADLER_MOD
    K2 = 1 << max(0, (K - 1).bit_length())
    if K2 != K:  # zero chunks appended at the END (handled by Z-correction)
        sa = jnp.concatenate([sa, jnp.zeros(K2 - K, jnp.uint32)])
        sb = jnp.concatenate([sb, jnp.zeros(K2 - K, jnp.uint32)])
    level_len = chunk
    while sa.shape[0] > 1:
        l2 = jnp.uint32(level_len % ADLER_MOD)
        sa_l, sa_r = sa[0::2], sa[1::2]
        sb_l, sb_r = sb[0::2], sb[1::2]
        sb = (sb_l + l2 * sa_l + sb_r) % ADLER_MOD
        sa = (sa_l + sa_r) % ADLER_MOD
        level_len *= 2
    sa, sb = sa[0], sb[0]
    # Remove the Z = K2*chunk - n trailing zero bytes' weight inflation.
    m = jnp.uint32(ADLER_MOD)
    z = (jnp.uint32(K2 * chunk) - n) % m
    sb = (sb + m - (z * sa) % m) % m
    a0 = prev & 0xFFFF
    b0 = (prev >> 16) & 0xFFFF
    a = (a0 + sa) % m
    b = (b0 + (n % m) * (a0 % m) + sb) % m
    return (b << 16) | a


def crc32_device_tail(data, n, prev=0, lane_bytes: int = CRC_LANE_BYTES):
    """CRC-32 of the FIRST `n` bytes of uint8 `data` (trailing masked)."""
    return _crc32_device_tail(_pad_to(data, lane_bytes), np.uint32(n),
                              np.uint32(prev), lane_bytes)


@functools.partial(jax.jit, static_argnames=("lane_bytes",))
def _crc32_device_tail(data, n, prev, lane_bytes):
    N = data.shape[0]
    assert N % lane_bytes == 0
    idx = jnp.arange(N, dtype=jnp.uint32)
    x = jnp.where(idx < n, data, 0)
    lin_padded = _crc_linear_from_masked(x, lane_bytes)
    # L(X·0^Z) = L(X)·x^{8Z}  ->  undo the trailing zeros.
    zbits = jnp.uint32(8) * (jnp.uint32(N) - n)
    lin = _crc_unshift_dynamic_device(lin_padded, zbits)
    init = _crc_shift_dynamic_device(~prev & jnp.uint32(0xFFFFFFFF),
                                     jnp.uint32(8) * n)
    return (lin ^ init) ^ jnp.uint32(0xFFFFFFFF)


# --- device combine (for shard_map tree merges) ----------------------------

def crc32_combine_device(crc1, crc2, len2) -> jnp.ndarray:
    """Device-side crc32_combine with traced len2."""
    if isinstance(crc1, int):
        crc1 = np.uint32(crc1)
    if isinstance(crc2, int):
        crc2 = np.uint32(crc2)
    if isinstance(len2, int):
        len2 = np.uint32(len2)
    nbits = jnp.uint32(8) * jnp.asarray(len2, jnp.uint32)
    t1 = _crc_shift_dynamic_device(jnp.asarray(crc1, jnp.uint32), nbits)
    return t1 ^ jnp.asarray(crc2, jnp.uint32)


def adler32_combine_device(a1, a2, len2) -> jnp.ndarray:
    if isinstance(a1, int):
        a1 = np.uint32(a1)
    if isinstance(a2, int):
        a2 = np.uint32(a2)
    if isinstance(len2, int):
        len2 = np.uint32(len2)
    a1 = jnp.asarray(a1, jnp.uint32)
    a2 = jnp.asarray(a2, jnp.uint32)
    rem = jnp.asarray(len2, jnp.uint32) % ADLER_MOD
    s1_1, s2_1 = a1 & 0xFFFF, (a1 >> 16) & 0xFFFF
    s1_2, s2_2 = a2 & 0xFFFF, (a2 >> 16) & 0xFFFF
    m = jnp.uint32(ADLER_MOD)
    s1 = (s1_1 + s1_2 + m - 1) % m
    s2 = (s2_1 + s2_2 + rem * ((s1_1 + m - 1) % m)) % m
    return (s2 << 16) | s1
