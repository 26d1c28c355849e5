"""Batched rank/occ primitives on the fused table (port of
``sview_fmindex_tpu.ops.rank``).

The fused table packs, per block, the rank checkpoint row and the bit-plane
lanes into one row of 32-bit words (int32 tensors holding uint32 bit
patterns):

    fused[b] = [ ckpt[b,0..sigma) | plane0_lane0..plane0_laneL | plane1... ]

Lane l covers block positions [32l, 32l+32), MSB-first: position i maps to
bit ``31 - i%32``.  Positions, ranks and counts are int64; every shift and
complement is masked to 32 bits.

Semantics reproduced exactly:
- ``get_next_rank`` (``bwm/mod.rs:197-215``): +1 position shift below the
  sentinel row; checkpoint + popcount of the top ``rem`` positions.
- ``get_pre_rank_and_symidx`` (``bwm/mod.rs:217-236``): also decodes the
  symbol at the position; the sentinel row itself is signalled by a mask.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def u32(words: torch.Tensor) -> torch.Tensor:
    """32-bit words (int32 bit patterns) -> int64 values in [0, 2^32).

    int64 tensors already hold values (the wide engine's SA, dense and
    checkpoint tables, ``ops/wide.py``) and are returned as they are, so
    the table's dtype decides whether a mask applies."""
    if words.dtype == torch.int64:
        return words
    return words.long() & M32


def to_i32(values: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors holding the same bits."""
    return torch.where(values >= 2**31, values - 2**32, values).to(torch.int32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 tensors holding 32-bit values (torch has no
    popcount op)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def _split_pos(meta, sentinel, pos: torch.Tensor):
    """Sentinel shift + block/rem split.  pos int64 [...]."""
    p = pos + (pos < sentinel).long()
    shift = meta.block_len.bit_length() - 1
    return p >> shift, p & (meta.block_len - 1)


def _lane_masks(num_lanes: int, rem: torch.Tensor) -> torch.Tensor:
    """Per-lane bitmask selecting positions < rem: int64 [..., num_lanes]."""
    lanes32 = torch.arange(num_lanes, device=rem.device) * 32
    take = (rem[..., None] - lanes32).clamp(0, 32)
    return ((torch.ones_like(take) << take) - 1) << (32 - take)


def _combine_planes(planes: torch.Tensor, symidx: torch.Tensor) -> torch.Tensor:
    """AND/NOT-combine plane lanes to isolate one symbol.

    planes int64 [..., num_planes, num_lanes], symidx int64 [...] ->
    int64 [..., num_lanes] with a 1 bit where the block symbol == symidx.
    """
    num_planes = planes.shape[-2]
    bits = (symidx[..., None] >> torch.arange(num_planes, device=planes.device)) & 1
    sel = torch.where(bits[..., None] == 1, planes, planes ^ M32)
    out = sel[..., 0, :]
    for j in range(1, num_planes):
        out = out & sel[..., j, :]
    return out


def _plane_lanes(meta, rows: torch.Tensor) -> torch.Tensor:
    """rows int64 [..., W] -> plane lanes [..., num_planes, num_lanes]: the
    row's last ``num_planes * num_lanes`` words, which follow its
    checkpoints."""
    width = meta.num_planes * meta.num_lanes
    return rows[..., rows.shape[-1] - width:].reshape(
        *rows.shape[:-1], meta.num_planes, meta.num_lanes)


def derive_fused_device(meta, planes: torch.Tensor, text_len: int) -> torch.Tensor:
    """Derive the fused table from its plane columns alone.

    ``planes``: int32 ``[n_blocks, num_planes*num_lanes]`` (``fused[:,
    sigma:]``).  Returns int32 ``[n_blocks, sigma + num_planes*num_lanes]``
    with ``checkpoint[b, s]`` = count of symbol s before block b
    (``bwm/mod.rs:126-134``): an exclusive cumsum of per-block popcounts,
    with the final partial block's zero padding (``bwm/mod.rs:97-104``)
    masked out so it cannot count as symbol 0.
    """
    n_blocks = planes.shape[0]
    pl = u32(planes).reshape(n_blocks, meta.num_planes, meta.num_lanes)
    start = torch.arange(n_blocks, device=planes.device) * meta.block_len
    valid = (text_len - start).clamp(0, meta.block_len)
    lmask = _lane_masks(meta.num_lanes, valid)
    per_block = []
    for s in range(meta.sigma):
        sym = torch.full((n_blocks,), s, dtype=torch.int64, device=planes.device)
        comb = _combine_planes(pl, sym)
        per_block.append(popcount32(comb & lmask).sum(-1))
    cnt = torch.stack(per_block, dim=1)
    ckpt = torch.cumsum(cnt, dim=0) - cnt
    return torch.cat([to_i32(ckpt), planes], dim=1)


def rank_from_rows(meta, rows: torch.Tensor, rem: torch.Tensor,
                   symidx: torch.Tensor) -> torch.Tensor:
    """Rank math given gathered fused rows (int32 [..., W] words, or int64
    values)."""
    rows = u32(rows)
    ckpt = rows.gather(-1, symidx[..., None])[..., 0]
    combined = _combine_planes(_plane_lanes(meta, rows), symidx)
    return ckpt + popcount32(combined & _lane_masks(meta.num_lanes, rem)).sum(-1)


def rank_next(meta, fused: torch.Tensor, sentinel, pos: torch.Tensor,
              symidx: torch.Tensor) -> torch.Tensor:
    """Batched ``get_next_rank(pos, symidx)``: occurrences of symidx in the
    BWT strictly before (shifted) pos.  pos, symidx int64 [...]."""
    q, rem = _split_pos(meta, sentinel, pos)
    return rank_from_rows(meta, fused[q], rem, symidx)


def pre_rank_and_symidx(meta, fused: torch.Tensor, sentinel, pos: torch.Tensor):
    """Batched ``get_pre_rank_and_symidx(pos)``.

    Returns (rank int64, symidx int64, is_sentinel bool); rank/symidx are
    garbage where is_sentinel (the caller must mask), matching the
    reference's ``None`` at ``pos == sentinel_index - 1``.
    """
    is_sentinel = pos == sentinel - 1
    q, rem = _split_pos(meta, sentinel, pos)
    rank, symidx = pre_rank_and_symidx_from_rows(meta, fused[q], rem)
    return rank, symidx, is_sentinel


def pre_rank_and_symidx_from_rows(meta, rows: torch.Tensor, rem: torch.Tensor):
    """Decode + rank math given gathered fused rows (int32 [..., W] words,
    or int64 values)."""
    rows = u32(rows)
    planes = _plane_lanes(meta, rows)
    lane = (rem >> 5)[..., None, None].expand(*rem.shape, meta.num_planes, 1)
    lane_vals = planes.gather(-1, lane)[..., 0]
    bit = 31 - (rem & 31)
    plane_bits = (lane_vals >> bit[..., None]) & 1
    weights = torch.arange(meta.num_planes, device=rows.device)
    symidx = (plane_bits << weights).sum(-1)
    ckpt = rows.gather(-1, symidx[..., None])[..., 0]
    combined = _combine_planes(planes, symidx)
    rank = ckpt + popcount32(combined & _lane_masks(meta.num_lanes, rem)).sum(-1)
    return rank, symidx
