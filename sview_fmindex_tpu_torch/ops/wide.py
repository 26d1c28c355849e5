"""Wide-position (u64) engine: texts of 2^32 bp and more (port of
``sview_fmindex_tpu.ops.wide``).

The reference treats u64 as a first-class ``Position``
(``src/text_length.rs:87-129``).  The port carries positions, ranks, counts
and located positions as int64, so u64 VALUES need no lanes; only the
tables made of 32-bit words are laid out for them:

- ``fused`` int32 [n_blocks, 2*sigma + planes*lanes]: checkpoint HI words,
  checkpoint LO words, then the MSB-first plane lanes (the JAX layout; a
  rank reads ``(u32(hi) << 32) | u32(lo)``),
- ``stream_tbl`` int32 [n_blocks128, RW] with SEGMENT-LOCAL checkpoints, and
  ``seg_base`` int64 [n_segs, sigma], the global count at each segment
  start (``ops.stream_join.derive_stream_table_wide``).  The join kernel's
  segmented modes add the base, so the stream engine's ranks are global,
- ``sa``, ``kmer_tbl``, ``count_arr``, ``dense_lo``/``dense_hi``: int64
  values, which ``ops.rank.u32`` passes through unmasked.

Engines: the stream engine (sorted passes through the segmented rank mode;
uniform-length batches stay sorted across passes, :func:`_wide_ranges_chain`)
and the gather engine (fused-row gathers); the locate walk decodes through
the segmented decode mode or by gathers.  No pair table and no full SA, as
in the JAX upload; host-built dense seeds are on.

JAX functions with no counterpart here, and why:

- ``p_add_u32``, ``p_add``, ``p_sub``, ``p_lt``, ``p_where``,
  ``p_divmod_const``, ``combine64``: two-lane uint32 arithmetic; int64 does
  it natively (``pos % r`` and ``pos // r`` for any ratio).
- ``_wide_stream_prep``, ``_seg_base_at`` and the ``idx<<13 | rem<<6 |
  sym`` payload: the TPU kernel's u32 block-id sort key, which keeps keys
  32-bit below 2^38 bp; the port sorts the int64 position, and the kernel
  adds the segment base itself.
- ``STREAM_WIDE_MAX_LANES`` and the chain's ``(steps-1)*w <= 30`` gate: the
  budgets of that packed payload; sorts here carry lane indices.
- ``rank_from_rows_wide``, ``pre_rank_and_symidx_from_rows_wide``,
  ``_plane_lanes_wide``, ``_combine_planes``, ``_split_pos_wide``:
  :func:`wide_rows` turns wide rows into the narrow layout with int64
  checkpoints, and the narrow ``ops.rank`` math serves them.
- ``initial_range_wide`` and ``expand_ranges_wide`` are the narrow
  functions on int64 tables (aliased below).
"""
from __future__ import annotations

import torch

from . import locate as locate_ops
from . import search as search_ops
from . import stream_join as sj
from .rank import _split_pos, pre_rank_and_symidx_from_rows, rank_from_rows, u32

# the narrow functions, unchanged: the k-mer and dense tables hold int64
# values, which u32() leaves as they are
initial_range_wide = search_ops.initial_range
expand_ranges_wide = locate_ops.expand_ranges


def wide_rows(meta, rows: torch.Tensor) -> torch.Tensor:
    """Wide fused rows (int32 [..., 2*sigma + P*L]: hi | lo | planes) ->
    int64 rows in the narrow layout (checkpoint values | plane words)."""
    s = meta.sigma
    ckpt = (u32(rows[..., :s]) << 32) | u32(rows[..., s:2 * s])
    return torch.cat([ckpt, u32(rows[..., 2 * s:])], dim=-1)


def rank_next_wide(meta, fused: torch.Tensor, sentinel, pos: torch.Tensor,
                   symidx: torch.Tensor) -> torch.Tensor:
    """``get_next_rank`` on the wide fused table.  pos, symidx int64."""
    q, rem = _split_pos(meta, sentinel, pos)
    return rank_from_rows(meta, wide_rows(meta, fused[q]), rem, symidx)


def pre_rank_and_symidx_wide(meta, fused: torch.Tensor, sentinel, pos: torch.Tensor):
    """``get_pre_rank_and_symidx`` on the wide fused table: (rank, symidx,
    is_sentinel); rank/symidx are garbage where is_sentinel."""
    q, rem = _split_pos(meta, sentinel, pos)
    rank, symidx = pre_rank_and_symidx_from_rows(meta, wide_rows(meta, fused[q]), rem)
    return rank, symidx, pos == sentinel - 1


def pos_ranges_wide(dev, sym: torch.Tensor, lens: torch.Tensor, steps: int,
                    use_stream: bool = False, all_dense: bool = False,
                    fixed_len: int | None = None):
    """Backward search on a wide index: (lo, hi) int64 [B].

    ``use_stream`` ranks through the segmented sort-join (uniform-length
    batches take the sorted chain), the gather engine otherwise."""
    meta = dev.meta
    lo, hi, rem_steps, seed_len = initial_range_wide(
        meta, dev.kmer_tbl, dev.dense_lo, dev.dense_hi, sym, lens,
        all_dense=all_dense, fixed_len=fixed_len)
    if steps == 0:
        return lo, hi
    if use_stream and fixed_len is not None:
        # one length => one seed => every lane takes exactly ``steps`` steps
        seed = meta.dense_k if meta.dense_k and fixed_len >= meta.dense_k else meta.kmer_size
        return _wide_ranges_chain(dev, lo, hi, sym, fixed_len - seed - 1, steps)
    if use_stream:
        def rank(pos, s):
            return sj.rank_next_sorted_wide(dev.stream_tbl, dev.seg_base, dev.sentinel,
                                            pos, s, meta.sigma)
    else:
        def rank(pos, s):
            return rank_next_wide(meta, dev.fused, dev.sentinel, pos, s)
    for t in range(steps):
        lo, hi = search_ops.lf_step(dev.count_arr, rank,
                                    search_ops.sym_back(sym, lens, seed_len, t),
                                    lo, hi, (t < rem_steps) & (lo < hi))
    return lo, hi


def _wide_ranges_chain(dev, lo, hi, sym, j0: int, steps: int):
    """Wide backward search staying in SORTED order across stream passes
    (the counterpart of ``ops.search._ranges_chain`` with sigma codes): one
    sort per pass and one unsort at the end.  ``j0`` is the column of the
    first LF symbol."""
    B = lo.shape[0]
    pos = torch.cat([lo, hi])
    lane = torch.arange(2 * B, device=pos.device)
    for t in range(steps):
        _, lane, c, ranks = search_ops.sorted_pass(
            pos, lane, sym[:, j0 - t], dev.stream_tbl, dev.meta.sigma, dev.sentinel,
            dev.seg_base)
        pos = dev.count_arr[c] + ranks
    return search_ops.unsort(pos, lane, B)


def walk_rows_wide(meta, fused, count_arr, sa, sentinel, rows, valid,
                   stream_tbl=None, seg_base=None, use_stream: bool = False):
    """LF walk on a wide index (any sampling ratio); ``use_stream`` decodes
    through the segmented decode mode instead of wide fused-row gathers."""
    if use_stream:
        def decode(pos):
            return sj.pre_rank_and_symidx_sorted_wide(stream_tbl, seg_base, sentinel,
                                                      pos, meta.sigma)
    else:
        def decode(pos):
            return pre_rank_and_symidx_wide(meta, fused, sentinel, pos)
    return locate_ops.lf_walk(meta.sampling_ratio, count_arr, sa, rows, valid, decode)


def locate_rows_wide(meta, fused, count_arr, sa, sentinel, lo, hi, capacity: int,
                     stream_tbl=None, seg_base=None, use_stream: bool = False):
    """Expand + walk: (locs int64, pat_ids int64, valid bool, dropped)."""
    rows, pids, valid, dropped = expand_ranges_wide(lo, hi, capacity)
    locs = walk_rows_wide(meta, fused, count_arr, sa, sentinel, rows, valid,
                          stream_tbl, seg_base, use_stream)
    return locs, pids, valid, dropped
