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

The canonical in-memory layout here is uint32 lanes, big-endian within the
vector: ``planes_u32[b, j, l]`` covers positions [32l, 32l+32) of block b,
bit (31 - i%32) <-> position i.  The blob's little-endian vector bytes are a
pure byte-reversal per vector (see :func:`lanes_to_blob_bytes`).
"""
from __future__ import annotations

import numpy as np

from ..config import BlockKind

_CHUNK = 1 << 24


def checkpoints_and_planes(
    bwt_plus1: np.ndarray, symbol_count: int, kind: BlockKind
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (rank_checkpoints uint64 [n_blocks, sigma],
                planes uint32 [n_blocks, num_planes, num_lanes])."""
    n = len(bwt_plus1)
    L = kind.block_len
    sigma = symbol_count
    n_blocks = n // L + 1
    data_blocks = -(-n // L)  # ceil; == n_blocks unless n % L == 0

    symidx = bwt_plus1 - np.uint8(1)

    # --- checkpoints: exclusive cumulative per-symbol counts per block ---
    # (equality-sum over the reshaped block matrix; orders of magnitude
    # faster than a flat bincount for Gbp inputs).  Zero padding of the
    # final partial block inflates its symbol-0 count, but that block's
    # counts only ever feed the unused last cumsum row: when pad > 0,
    # data_blocks == n_blocks and ckpt rows stop at cum[n_blocks - 2].
    pad = data_blocks * L - n
    if pad:
        sym2d = np.concatenate([symidx, np.zeros(pad, np.uint8)]).reshape(
            data_blocks, L
        )
    else:
        sym2d = symidx.reshape(data_blocks, L)
    per_block = np.empty((data_blocks, sigma), dtype=np.int64)
    for c in range(sigma):
        per_block[:, c] = (sym2d == c).sum(axis=1)
    cum = np.cumsum(per_block, axis=0, dtype=np.int64)
    # row 0 = zeros; row b = counts before block b.  Whether the last data
    # block is partial (data_blocks == n_blocks) or the text divides evenly
    # (extra checkpoint row = totals, bwm/mod.rs:136-137), this is the
    # exclusive cumsum truncated to n_blocks rows.
    ckpt = np.zeros((n_blocks, sigma), dtype=np.uint64)
    ckpt[1:] = cum[: n_blocks - 1].astype(np.uint64)

    # --- bit planes, MSB-first (reuses the zero-padded sym2d) ---
    lanes = np.empty((n_blocks, kind.num_planes, kind.num_lanes), dtype=np.uint32)
    for j in range(kind.num_planes):
        bits = (sym2d >> j) & 1
        packed = np.packbits(bits, axis=1)  # big-endian bits AND bytes
        lanes[:data_blocks, j, :] = (
            packed.reshape(data_blocks, kind.num_lanes, 4)
            .view(">u4")
            .astype(np.uint32)
            .reshape(data_blocks, kind.num_lanes)
        )
    if data_blocks < n_blocks:
        lanes[data_blocks:] = 0  # the extra all-zero block (bwm/mod.rs:136-138)
    return ckpt, lanes


def lanes_to_blob_bytes(lanes: np.ndarray, kind: BlockKind) -> bytes:
    """uint32 big-endian lanes -> the blob's little-endian vector bytes.

    A vector's integer value has lane 0 as its most-significant 32 bits; the
    blob stores it little-endian, i.e. bytes fully reversed per vector.
    """
    n_blocks = lanes.shape[0]
    be_bytes = lanes.astype(">u4").view(np.uint8).reshape(
        n_blocks, kind.num_planes, kind.num_lanes * 4
    )
    le_bytes = be_bytes[:, :, ::-1]
    return np.ascontiguousarray(le_bytes).tobytes()


def blob_bytes_to_lanes(raw: np.ndarray, n_blocks: int, kind: BlockKind) -> np.ndarray:
    """Inverse of :func:`lanes_to_blob_bytes`; ``raw`` is a uint8 view."""
    vb = kind.num_lanes * 4
    le = raw.reshape(n_blocks, kind.num_planes, vb)
    be = le[:, :, ::-1]
    return (
        np.ascontiguousarray(be)
        .view(">u4")
        .astype(np.uint32)
        .reshape(n_blocks, kind.num_planes, kind.num_lanes)
    )
