"""Burrows-Wheeler-Matrix body: rank checkpoints + bit-sliced blocks.

Reproduces ``BwmHeader::encode_bwm_body`` (``src/components/bwm/mod.rs:91-143``)
and ``Block::vectorize`` (``blocks/block2.rs:18-33`` et al.) vectorized:

- blocks_len = text_len // BLOCK_LEN + 1 (one extra block always,
  ``bwm/mod.rs:78``),
- checkpoint row b = per-symbol counts before position b*BLOCK_LEN,
- each block stores ``num_planes`` bit-plane vectors; plane j holds bit j of
  each symbol index, MSB-first (the reference shifts symbols in from the
  right, so the first symbol of a block ends in the vector's MSB),
- a final partial block is left-shifted by ``BLOCK_LEN - rem``
  (``bwm/mod.rs:97-104,140-142``) == MSB-first packing padded with 0 bits;
  an exactly-full text appends one all-zero block (``bwm/mod.rs:136-138``).

MSB-first packing of a block's bits (``np.packbits``) is the vector's
big-endian bytes; the blob stores each vector little-endian, i.e. those
bytes reversed.  The body is written block range by block range, about
``_CHUNK`` positions at a time, straight into the blob.
"""
from __future__ import annotations

import numpy as np

from ..config import BlockKind

_CHUNK = 1 << 18


def write_bwm_body(
    bwt_plus1: np.ndarray, symbol_count: int, kind: BlockKind,
    ckpt_out: np.ndarray, blocks_out: np.ndarray,
) -> None:
    """Write the rank checkpoints into ``ckpt_out`` ([n_blocks * sigma], the
    blob's position type) and the bit planes into ``blocks_out`` (uint8
    [n_blocks * block_bytes]).  Both must start zeroed: the extra all-zero
    block is not written."""
    n = len(bwt_plus1)
    L = kind.block_len
    sigma = symbol_count
    n_blocks = n // L + 1
    data_blocks = -(-n // L)  # ceil; == n_blocks unless n % L == 0
    ckpt = ckpt_out.reshape(n_blocks, sigma)
    blocks = blocks_out.reshape(n_blocks, kind.num_planes, L // 8)
    carry = np.zeros(sigma, dtype=np.int64)  # counts before the current block
    step = max(1, _CHUNK // L)
    for b0 in range(0, data_blocks, step):
        b1 = min(b0 + step, data_blocks)
        # the final partial block is zero-padded: its symbol-0 count is
        # inflated, but only ever lands in a checkpoint row when the text
        # divides evenly, and then there is no padding
        sym = np.zeros((b1 - b0) * L, dtype=np.uint8)
        seg = bwt_plus1[b0 * L : b1 * L]
        np.subtract(seg, np.uint8(1), out=sym[: len(seg)])
        sym2d = sym.reshape(b1 - b0, L)
        per_block = np.empty((b1 - b0, sigma), dtype=np.int64)
        for c in range(sigma):
            per_block[:, c] = (sym2d == c).sum(axis=1)
        cum = np.cumsum(per_block, axis=0)
        ckpt[b0] = carry
        ckpt[b0 + 1 : b1] = carry + cum[:-1]
        carry += cum[-1]
        for j in range(kind.num_planes):
            packed = np.packbits((sym2d >> j) & 1, axis=1)  # big-endian bits AND bytes
            blocks[b0:b1, j] = packed[:, ::-1]
    if n_blocks > data_blocks:
        ckpt[data_blocks] = carry  # the extra block's row: the totals
