"""Token tape — the interchange format between decode frontends and the
device resolver.

The reference interleaves symbol decode and byte materialization in one
sequential loop (deflate.lisp:673-702). This codec splits that into
two phases: a *frontend* (host native / host Python / device kernel)
turns the bit stream into this fixed-width structure-of-arrays tape, and
the *resolver* (ops/resolve.py) turns the tape into output bytes with
prefix sums and gathers. The tape is a plain pytree of arrays so it can
be device_put, sharded, and carried through jit.

Token encoding (three parallel int32 arrays):
  dist > 0                  : LZ77 match, `out_len` = match length (3..258),
                              source = current_pos - dist (may reach into a
                              carried 32KB window).
  dist == 0, root_val < 256 : literal byte `root_val`, out_len == 1.
  dist == 0, root_val >= STORED_FLAG : stored-block run — copy `out_len`
                              bytes from the *input* byte offset
                              (root_val - STORED_FLAG).
"""

from __future__ import annotations

import dataclasses

import numpy as np

STORED_FLAG = 1 << 30


@dataclasses.dataclass
class BlockInfo:
    """Per-block metadata (debugging, streaming, and shard planning)."""
    btype: int            # constants.BTYPE_*
    bfinal: bool
    start_bit: int        # absolute bit offset of the block's first header bit
    end_bit: int          # absolute bit offset just past the block
    token_start: int      # tape index range [token_start, token_end)
    token_end: int
    out_start: int        # output byte range produced by this block
    out_end: int


@dataclasses.dataclass
class TokenTape:
    out_len: np.ndarray   # int32[N] bytes produced by each token
    dist: np.ndarray      # int32[N] match distance, 0 for literal/stored
    root_val: np.ndarray  # int32[N] literal byte or STORED_FLAG|input_offset
    total_out: int        # sum(out_len)

    def __len__(self) -> int:
        return len(self.out_len)

    @staticmethod
    def from_lists(out_len, dist, root_val) -> "TokenTape":
        ol = np.asarray(out_len, dtype=np.int32)
        return TokenTape(
            out_len=ol,
            dist=np.asarray(dist, dtype=np.int32),
            root_val=np.asarray(root_val, dtype=np.int32),
            total_out=int(ol.sum()),
        )


@dataclasses.dataclass
class FrontendResult:
    """Result of tokenizing one raw-deflate stream (or a prefix of one)."""
    tape: TokenTape
    blocks: list
    end_bit: int          # bit offset just past the final consumed block
    finished: bool        # saw BFINAL block end
