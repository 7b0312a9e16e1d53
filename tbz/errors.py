"""Error types and device-safe error codes.

The reference raises Lisp conditions on malformed input (e.g.
huffman-tree.lisp:117,122, zlib.lisp:22-36, gzip.lisp:121-134). Device
kernels cannot raise, so the device path reports numeric error codes that
the host orchestration maps onto these exception types; the host-side
paths raise directly.
"""

from __future__ import annotations


class DeflateError(Exception):
    """Malformed DEFLATE/zlib/gzip stream."""

    def __init__(self, message: str, code: int = 1):
        super().__init__(message)
        self.code = code


class ChecksumError(DeflateError):
    """Adler-32 / CRC-32 / FHCRC mismatch."""


class TruncatedError(DeflateError):
    """Input ended mid-stream (non-resumable, one-shot APIs only)."""


# Numeric error codes surfaced from jitted/device code (0 == OK).
OK = 0
ERR_BAD_BLOCK_TYPE = 1        # BTYPE == 3
ERR_STORED_LEN_MISMATCH = 2   # LEN != ~NLEN
ERR_TRUNCATED = 3
ERR_BAD_HUFFMAN = 4           # over-subscribed / illegally incomplete code
ERR_INVALID_CODE = 5          # hit an unused table slot
ERR_BAD_DISTANCE = 6          # distance past start of output/window
ERR_BAD_CL_REPEAT = 7         # repeat code 16 with no previous length
ERR_TOO_MANY_SYMBOLS = 8      # HLIT > 286 or HDIST > 30
ERR_CHECKSUM = 9
ERR_HEADER = 10               # bad zlib/gzip header
ERR_TAPE_OVERFLOW = 11        # token tape capacity exceeded (internal)
ERR_PLAN_DEPTH = 12           # span-plan dependency depth cap (fallback)

_MESSAGES = {
    ERR_BAD_BLOCK_TYPE: "invalid block type 3",
    ERR_STORED_LEN_MISMATCH: "stored block LEN/NLEN mismatch",
    ERR_TRUNCATED: "truncated deflate stream",
    ERR_BAD_HUFFMAN: "invalid Huffman code lengths",
    ERR_INVALID_CODE: "invalid Huffman code in stream",
    ERR_BAD_DISTANCE: "distance too far back",
    ERR_BAD_CL_REPEAT: "code-length repeat with no previous length",
    ERR_TOO_MANY_SYMBOLS: "too many literal/length or distance symbols",
    ERR_CHECKSUM: "checksum mismatch",
    ERR_HEADER: "invalid stream header",
    ERR_TAPE_OVERFLOW: "internal: token tape overflow",
    ERR_PLAN_DEPTH: "internal: span plan dependency depth cap",
}


def raise_for_code(code: int) -> None:
    if code == OK:
        return
    msg = _MESSAGES.get(code, f"deflate error {code}")
    if code == ERR_CHECKSUM:
        raise ChecksumError(msg, code)
    if code == ERR_TRUNCATED:
        raise TruncatedError(msg, code)
    raise DeflateError(msg, code)
