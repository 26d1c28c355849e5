"""Batched two-phase locate (port of ``sview_fmindex_tpu.ops.locate``).

Phase 1 (ranges) is :func:`ops.search.pos_ranges`.  Phase 2 expands the
[lo, hi) ranges into a flat row buffer of fixed capacity (the batched analog
of ``P::as_vec_in_range``, ``locate/mod.rs:19``): slot ``p < B`` holds the
FIRST occurrence row of pattern p (valid iff count >= 1), slots
``B..capacity`` the overflow (2nd+ occurrences), placed by a searchsorted
over the overflow prefix sums.  Phase 3 resolves every row to a text
location: one gather when the full (r=1) SA is resident, else the LF walk
with the sentinel-row short-circuit (``locate/mod.rs:21-35``): on a card one
launch of the kernel ``csrc/lf_walk.cu`` (:func:`walk_rows_cuda`), on the
CPU :func:`lf_walk`, its plain version, decoding by fused-row gathers or
through the join kernel's decode mode.  Output order is unspecified;
consumers key on ``pat_ids``/``valid``.
"""
from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from .. import tracing
from . import stream_join as sj
from .rank import pre_rank_and_symidx, u32
from .search import check_kernel_tables

_SAT_CAP = 0x7FFFFFFF
# launches of the LF walk's kernel ("walk"), counted where it is launched,
# so a run can show its walk went through it
LAUNCHES: collections.Counter = collections.Counter()


def _capacity(B: int, extra: int) -> int:
    """The expand buffer's one sizing rule: ``B`` base slots plus the
    ``extra`` overflow rows rounded up to a power of two (at least 64)."""
    return B + max(1 << max(extra - 1, 1).bit_length(), 64)


def expand_capacity(counts, base: int | None = None) -> int:
    """Host-side capacity for :func:`expand_ranges` from counts already on
    the host: ``B`` base slots plus the overflow rounded up to a power of
    two (at least 64)."""
    counts = np.asarray(counts)
    B = base if base is not None else counts.shape[0]
    extra = int((counts - (counts >= 1)).sum())
    return _capacity(B, extra)


def device_capacity(counts: torch.Tensor) -> tuple[int, int]:
    """``(capacity, rows)`` for :func:`expand_ranges` from the counts where
    they lie: the exact int64 sums ``rows`` and the lanes with a count
    (counts are >= 0, so ``rows`` less them is ``expand_capacity``'s
    overflow ``sum(counts - (counts >= 1))``) are reduced on the counts'
    device into one [2] tensor and read in one copy of 16 bytes, counted as
    one of the ``syncs`` and as ``capacity_bytes``; the capacity equals
    ``expand_capacity`` over the same counts."""
    sums = torch.empty(2, dtype=torch.int64, device=counts.device)
    torch.sum(counts, 0, out=sums[0])
    torch.sum(counts != 0, 0, out=sums[1])
    tracing.count("syncs")
    tracing.count("capacity_bytes", sums.nbytes)
    rows, nonzero = sums.tolist()
    return _capacity(counts.shape[0], rows - nonzero), rows


def _sat_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Prefix sum saturating at 2^31-1.  All terms are >= 0, so clamping
    the terms and then the plain sum equals the reference's saturating
    scan: exact below the cap, pinned at it above."""
    return torch.cumsum(x.clamp(max=_SAT_CAP), 0).clamp(max=_SAT_CAP)


def expand_ranges(lo: torch.Tensor, hi: torch.Tensor, capacity: int):
    """[B] ranges -> (rows int64 [capacity], pat_ids int64, valid bool,
    dropped int64 [1]).

    Slot p < B: row ``lo[p]``.  Slots B..: overflow rows ``lo[p]+1 ..
    hi[p])`` in pattern order; overflow beyond ``capacity - B`` is dropped
    and counted in ``dropped`` (a lower bound once the saturating sum pins;
    ``dropped == 0`` is always exact).  Requires ``capacity >= B``.
    """
    B = lo.shape[0]
    if capacity < B:
        raise ValueError(f"capacity {capacity} < batch {B}: the expand "
                         "layout needs one base slot per pattern")
    counts = hi - lo
    base_valid = counts >= 1
    O = capacity - B
    extra = counts - base_valid.long()
    ecum = _sat_cumsum(extra)
    etotal = ecum[-1:] if B else torch.zeros(1, dtype=torch.int64, device=lo.device)
    dropped = etotal - etotal.clamp(max=O)
    base_rows = torch.where(base_valid, lo, 0)
    base_pids = torch.arange(B, device=lo.device)
    if O == 0 or B == 0:
        rows = torch.cat([base_rows, torch.zeros(O, dtype=torch.int64, device=lo.device)])
        pids = torch.cat([base_pids, torch.zeros(O, dtype=torch.int64, device=lo.device)])
        valid = torch.cat([base_valid, torch.zeros(O, dtype=torch.bool, device=lo.device)])
        return rows, pids, valid, dropped
    j = torch.arange(O, device=lo.device)
    epat = torch.searchsorted(ecum, j, right=True).clamp(0, B - 1)
    prev = torch.where(epat == 0, 0, ecum[(epat - 1).clamp(min=0)])
    erows = lo[epat] + 1 + (j - prev)
    evalid = j < etotal
    rows = torch.cat([base_rows, torch.where(evalid, erows, 0)])
    pids = torch.cat([base_pids, epat])
    valid = torch.cat([base_valid, evalid])
    return rows, pids, valid, dropped


def lf_walk(r: int, count_arr, sa, rows, valid, decode):
    """Resolve BWT rows to text locations by LF-walking until the row is a
    multiple of the sampling ratio ``r`` (``locate/mod.rs:21-35``), with the
    sentinel-row short-circuit.  ``decode(pos)`` returns (rank, symidx,
    is_sentinel) at every position (the narrow or wide decode, gather or
    sort-join).  ``sa`` is the sampled SA, or a function from sample indices
    to SA values (a range-sharded SA is gathered collectively).  Returns
    int64 [capacity].

    Traced (span ``fmindex.walk``, the loop and the final SA read), each
    step test reads the count of live rows, one of the ``syncs``; a step
    that decodes adds 1 to ``walk_steps``, its live rows to
    ``walk_row_steps`` and the lanes it sends to ``decode`` to
    ``walk_lanes``."""
    with tracing.span("fmindex.walk"):
        for key in ("walk_steps", "walk_row_steps", "walk_lanes"):
            tracing.count(key, 0)
        pos = rows
        offset = torch.zeros_like(rows)
        loc = torch.zeros_like(rows)
        done = torch.zeros_like(valid)
        while r > 1:
            need = (pos % r != 0) & ~done & valid
            tracing.count("syncs")
            live = int(need.sum())
            if not live:
                break
            tracing.count("walk_steps")
            tracing.count("walk_row_steps", live)
            tracing.count("walk_lanes", need.numel())
            rank, symidx, is_sent = decode(torch.where(need, pos, 0))
            hit = need & is_sent
            loc = torch.where(hit, offset, loc)
            done = done | hit
            step = need & ~is_sent
            pos = torch.where(step, count_arr[symidx] + rank, pos)
            offset = offset + step.long()
        sampled = sa(pos // r) if callable(sa) else u32(sa[pos // r])
        return torch.where(done, loc, sampled + offset)


def walk_rows_cuda(meta, fused, count_arr, sa, sentinel, rows, valid):
    """:func:`lf_walk` with the narrow decode (``ops/rank.pre_rank_and_symidx``)
    in one launch of ``csrc/lf_walk.cu``: int64 [capacity], equal to it bit
    for bit on every lane, invalid lanes included.  The rows and the tables
    (:func:`ops.search.check_kernel_tables`, with ``count_arr`` and the
    sampled SA ``sa``) are checked before the kernel's library is loaded;
    the kernel runs on the current stream and is not waited for.

    Span ``fmindex.walk``.  Each launch is counted in ``LAUNCHES["walk"]``
    and, while a profiler records, as ``walk_kernel``; then the kernel also
    gathers the decodes of all rows and of the row that took the most in a
    buffer read once after the launch (one of the ``syncs``), counted as
    ``walk_row_steps`` and ``walk_lanes`` (the decodes issued: one a row
    step) and ``walk_steps`` (the plain loop's steps).  Without a profiler
    the walk waits on nothing."""
    from .. import kernels

    if not rows.is_cuda:
        raise ValueError(f"the LF walk kernel runs on a CUDA device, rows are on {rows.device}")
    n = rows.shape[0]
    for name, t, dtype in (("rows", rows, torch.int64), ("valid", valid, torch.bool)):
        if (t.dtype != dtype or t.shape != (n,) or t.device != rows.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dtype} [{n}] tensor on "
                             f"{rows.device}, got {t.dtype} {list(t.shape)} on {t.device}")
    if fused.device != rows.device:
        raise ValueError(f"the index is on {fused.device}, the rows on {rows.device}")
    check_kernel_tables("LF walk", meta, fused, [("count_arr", count_arr, torch.int64, 1),
                                                 ("sa", sa, torch.int32, 1)])
    with tracing.span("fmindex.walk"):
        out = torch.empty_like(rows)
        traced = tracing.recording()
        stats = torch.zeros(2, dtype=torch.int64, device=rows.device) if traced else None
        if n:
            lib = kernels.lf_walk_lib()
            with torch.cuda.device(rows.device):
                stream = torch.cuda.current_stream(rows.device).cuda_stream
                err = lib.sview_lf_walk(
                    meta.num_planes, meta.num_lanes, meta.sigma, fused.data_ptr(),
                    fused.shape[1], count_arr.data_ptr(), count_arr.shape[0], sa.data_ptr(),
                    sentinel, meta.sampling_ratio, rows.data_ptr(), valid.data_ptr(), n,
                    out.data_ptr(), None if stats is None else stats.data_ptr(),
                    ctypes.c_void_p(stream))
            if err:
                raise RuntimeError(f"LF walk kernel launch failed: {kernels.cuda_error(err)}")
            LAUNCHES["walk"] += 1
            tracing.count("walk_kernel")
        if traced:
            tracing.count("syncs")
            row_steps, longest = stats.tolist()
            tracing.count("walk_steps", longest)
            tracing.count("walk_row_steps", row_steps)
            tracing.count("walk_lanes", row_steps)
        return out


def walk_rows(meta, fused, count_arr, sa, sentinel, rows, valid,
              stream_tbl=None, use_stream: bool = False):
    """LF walk on a narrow index: on a card the kernel
    (:func:`walk_rows_cuda`); else :func:`lf_walk`, each step decoding
    through the join kernel's decode mode over ``stream_tbl``
    (``use_stream``) or by fused-row gathers."""
    if fused.is_cuda:
        return walk_rows_cuda(meta, fused, count_arr, sa, sentinel, rows, valid)
    if use_stream:
        def decode(pos):
            return sj.pre_rank_and_symidx_sorted(stream_tbl, sentinel, pos, meta.sigma)
    else:
        def decode(pos):
            return pre_rank_and_symidx(meta, fused, sentinel, pos)
    return lf_walk(meta.sampling_ratio, count_arr, sa, rows, valid, decode)


def locate_rows(meta, fused, count_arr, sa, sentinel, lo, hi, capacity: int,
                stream_tbl=None, use_stream: bool = False):
    """Expand + resolve: (locs int64, pat_ids int64, valid bool, dropped)."""
    rows, pat_ids, valid, dropped = expand_ranges(lo, hi, capacity)
    if meta.has_sa_full:
        # the sentinel row's SA value 0 equals the offset the walk would
        # emit (locate/mod.rs:27-30), so one gather resolves every row
        locs = torch.where(valid, u32(sa[rows]), 0)
    else:
        locs = walk_rows(meta, fused, count_arr, sa, sentinel, rows, valid,
                         stream_tbl, use_stream)
    return locs, pat_ids, valid, dropped
