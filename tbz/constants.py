"""RFC 1951 constant tables for the tbz DEFLATE codec.

Semantics parity with the reference's table layer (constants.lisp:20-73 in
/root/reference), but laid out as NumPy arrays a device kernel can consume
directly instead of Lisp constant vectors.
"""

from __future__ import annotations

import numpy as np

# --- Block types (RFC 1951 §3.2.3) -----------------------------------------
BTYPE_STORED = 0
BTYPE_STATIC = 1
BTYPE_DYNAMIC = 2
BTYPE_RESERVED = 3

# --- Symbol space ----------------------------------------------------------
END_OF_BLOCK = 256          # litlen symbol terminating a block
MAX_LITLEN_SYMBOLS = 288    # 0..287 (286/287 reserved, present in fixed tree)
MAX_DIST_SYMBOLS = 32       # 0..31  (30/31 reserved, present in fixed tree)
MAX_CODE_LENGTH = 15        # longest Huffman code (RFC 1951 §3.2.1)
MAX_WINDOW = 32768          # LZ77 window size
MAX_MATCH = 258
MIN_MATCH = 3

# --- Length codes 257..285 (RFC 1951 §3.2.5) -------------------------------
# Base lengths and extra-bit counts, indexed by (symbol - 257).
LENGTH_BASE = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31,
     35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258],
    dtype=np.int32)
LENGTH_EXTRA = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2,
     3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0],
    dtype=np.int32)

# --- Distance codes 0..29 (RFC 1951 §3.2.5) --------------------------------
DIST_BASE = np.array(
    [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193,
     257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145,
     8193, 12289, 16385, 24577],
    dtype=np.int32)
DIST_EXTRA = np.array(
    [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6,
     7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13],
    dtype=np.int32)

# --- Code-length-code transmission order (RFC 1951 §3.2.7) -----------------
CODE_LENGTH_ORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15],
    dtype=np.int32)

# Code-length alphabet repeat codes.
CL_COPY_PREV = 16        # 2 extra bits, repeat previous length 3-6 times
CL_ZERO_SHORT = 17       # 3 extra bits, 3-10 zeros
CL_ZERO_LONG = 18        # 7 extra bits, 11-138 zeros

# --- Fixed (static) Huffman code lengths (RFC 1951 §3.2.6) -----------------
FIXED_LITLEN_LENGTHS = np.concatenate([
    np.full(144, 8), np.full(112, 9), np.full(24, 7), np.full(8, 8),
]).astype(np.int32)
assert FIXED_LITLEN_LENGTHS.shape == (288,)
FIXED_DIST_LENGTHS = np.full(32, 5, dtype=np.int32)

# --- Decode table sizing ---------------------------------------------------
# Root index widths for the two-level decode tables, and the total entry
# bounds proved sufficient by libz's ENOUGH computation (mirrors the
# reference's 852/592/+max table-size reasoning, constants.lisp:3-11).
LITLEN_ROOT_BITS = 9
DIST_ROOT_BITS = 6
ENOUGH_LITLEN = 852
ENOUGH_DIST = 592
ENOUGH_CODELEN = 128     # 19-symbol alphabet, 7-bit root: 2^7 = 128 suffices
CODELEN_ROOT_BITS = 7

# --- Packed decode-table entry layout (uint32) -----------------------------
#   bits  [0:4]   nbits   — code bits consumed at this level (1..15);
#                           for a link entry: the root width itself
#   op    [4:7]   entry kind
#   extra [7:12]  extra raw bits to read after the code (0..13);
#                           for a link entry: index width of the subtable
#   val   [16:32] payload — literal byte / length base / distance base /
#                           symbol id (code-length tables) / absolute
#                           subtable offset (link)
OP_LITERAL = 0
OP_MATCH = 1     # litlen table: length base; dist table: distance base
OP_END = 2       # end-of-block (litlen symbol 256)
OP_INVALID = 3   # unused table slot — decoding this is a stream error
OP_LINK = 4      # two-level link into a subtable

ENTRY_NBITS_SHIFT = 0
ENTRY_OP_SHIFT = 4
ENTRY_EXTRA_SHIFT = 7
ENTRY_VAL_SHIFT = 16


def pack_entry(op: int, nbits: int, extra: int, val: int) -> int:
    return (nbits & 0xF) | (op << ENTRY_OP_SHIFT) | (extra << ENTRY_EXTRA_SHIFT) | (val << ENTRY_VAL_SHIFT)


INVALID_ENTRY = pack_entry(OP_INVALID, 15, 0, 0)


def bit_reverse(code: int, nbits: int) -> int:
    """Reverse the low `nbits` bits of `code` (codes are MSB-first, the
    stream is read LSB-first — same role as util.lisp:59-69's table)."""
    out = 0
    for _ in range(nbits):
        out = (out << 1) | (code & 1)
        code >>= 1
    return out


# Vectorized 15-bit reversal table (built once).
_REV15 = np.zeros(1 << 15, dtype=np.int32)
_v = np.arange(1 << 15, dtype=np.int32)
for _i in range(15):
    _REV15 |= ((_v >> _i) & 1) << (14 - _i)


def bit_reverse_array(codes: np.ndarray, nbits: np.ndarray) -> np.ndarray:
    """Elementwise reversal of `nbits[i]`-bit codes (nbits in 1..15)."""
    return _REV15[codes] >> (15 - nbits)
