"""Range-sharded index: the big tables split across ranks by block range
(port of ``sview_fmindex_tpu.parallel.range_shard``).

Pattern-DP (``parallel/query.py``) holds the whole index on every device:
the right call while it fits.  When it does not, this layer shards the two
tables that grow with the text along their block / position dimension:

- ``fused``   [n_blocks, W]  -> ceil(n_blocks / D) rows per rank
- ``sa``      [n_sa]         -> ceil(n_sa / D) entries per rank (sampled or full)

while the O(sigma^k) tables (k-mer table, dense seeds, count array, encoder)
are whole on every rank.  A rank query's row gather becomes a collective:

    every rank gathers the rows it owns (a masked local gather) and an
    ``all_reduce(SUM)`` over the shard axis assembles the full rows on every
    rank (each global row has exactly one owner, so the sum IS a select).

The query batch is the same on every rank of the shard axis (each runs the
same lockstep search over its table slice): compute duplicates D-fold, memory
scales 1/D, which is the point; compose with pattern-DP on a 2-D ``(rs, dp)``
mesh to buy back compute.  Only the gather engine runs here (no stream or
pair table is built), so no hand kernel is launched.

Every rank of a shard group makes the same collective calls: the search
loop's trip count comes from the whole batch, and the walk's from the
reduced state, which is identical on all of them.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..build.dense_lut import auto_dense_k, dense_lut
from ..models import device_index as DI
from ..ops import locate as locate_ops
from ..ops import search as search_ops
from ..ops.rank import (
    _split_pos,
    pre_rank_and_symidx_from_rows,
    rank_from_rows,
    u32,
)
from ..ops.wide import wide_rows
from . import distributed
from .mesh import RS_AXIS, make_mesh
from .query import local_lens, pad_batch, shard_capacity

# collective row gathers since the last reset: calls, bytes reduced, and
# (only while TIME_COLLECTIVES is on, which synchronises the device around
# every call) the seconds they took
STATS = {"all_reduce_calls": 0, "all_reduce_bytes": 0, "all_reduce_seconds": 0.0}
TIME_COLLECTIVES = False


def _owned_gather(group, table_shard: torch.Tensor, idx: torch.Tensor,
                  start: int) -> torch.Tensor:
    """Collective row gather from a dim-0-sharded table.

    ``idx`` (global row ids int64, identical on every rank of the group) ->
    rows, identical on every rank: this rank owns rows ``start <= idx < start
    + n_local``, gathers those, zeros the rest, and the sum over the group
    selects (each row has one owner; the words are uint32 bit patterns in
    int32, or int64 values, and a sum with zeros is exact)."""
    n_local = table_shard.shape[0]
    mine = (idx >= start) & (idx < start + n_local)
    vals = table_shard[torch.where(mine, idx - start, 0)]
    mask = mine if vals.dim() == idx.dim() else mine[..., None]
    vals = torch.where(mask, vals, 0)
    STATS["all_reduce_calls"] += 1
    STATS["all_reduce_bytes"] += vals.numel() * vals.element_size()
    if not TIME_COLLECTIVES:
        return distributed.all_reduce_sum(vals, group)
    if vals.is_cuda:
        torch.cuda.synchronize(vals.device)
    t0 = time.perf_counter()
    out = distributed.all_reduce_sum(vals, group)
    if vals.is_cuda:
        torch.cuda.synchronize(vals.device)
    STATS["all_reduce_seconds"] += time.perf_counter() - t0
    return out


class RangeShardedFmIndex:
    """An FM-index whose fused and SA tables are range-sharded over the
    ranks of ``axis``.  Every rank makes the same calls with the same batch
    and gets the same answers.

    ``dp_axis``: optional second mesh axis for pattern data-parallelism:
    tables shard over ``axis`` (one copy per ``dp_axis`` coordinate), pattern
    batches shard over ``dp_axis``.
    """

    def __init__(self, fm, mesh=None, axis: str = RS_AXIS,
                 dp_axis: str | None = None,
                 sa_full: "np.ndarray | str | None" = None,
                 force_wide: bool = False,
                 dense_entries: int = 1 << 20):
        self.mesh = mesh if mesh is not None else make_mesh(axis=axis)
        self.axis = axis
        self.dp_axis = dp_axis
        names = self.mesh.axis_names
        if axis not in names or (dp_axis is not None and dp_axis not in names):
            raise ValueError(f"mesh axes {names} lack {axis!r} or {dp_axis!r}")
        if dp_axis is None and len(names) != 1:
            raise ValueError(f"a {names} mesh needs dp_axis")
        device = self.mesh.device
        D = self.mesh.size(axis)
        r = self.mesh.coord(axis)

        # PER-RANK staging: each rank assembles only its own table slice,
        # straight from the blob's zero-copy views; the full fused table or
        # SA is never materialised on any host or device
        wide = force_wide or fm.text_len >= 2**32
        if wide and sa_full is not None:
            raise ValueError("sa_full is a narrow-path option")
        sigma = fm.symbol_count
        kind = fm.block
        planes_eff = DI.planes_effective(fm)
        # dense seeds are a host pass of random rank gathers over the blob
        # views; ``dense_entries=0`` skips it when staging time matters more
        # than per-query LF steps
        dk = auto_dense_k(sigma, fm.kmer_size, dense_entries or 0, text_len=fm.text_len)
        if isinstance(sa_full, str):
            sa_full = np.memmap(sa_full, dtype="<u4", mode="r")
        self.meta = DI.IndexMeta(
            sigma=sigma, kmer_size=fm.kmer_size, sampling_ratio=fm.sampling_ratio,
            block_len=kind.block_len, num_planes=planes_eff, num_lanes=kind.num_lanes,
            dense_k=dk, wide_pos=wide, has_sa_full=sa_full is not None)

        nb = fm.rank_checkpoints.shape[0]
        self.fused_local = -(-nb // D)
        self.fused_start = r * self.fused_local
        b0, b1 = self.fused_start, min(self.fused_start + self.fused_local, nb)
        rows_fn = DI.wide_fused_rows if wide else DI.narrow_fused_rows
        width = (2 * sigma if wide else sigma) + planes_eff * kind.num_lanes
        rows = np.zeros((self.fused_local, width), np.uint32)  # zero rows pad the last shard
        if b1 > b0:
            rows[:b1 - b0] = rows_fn(fm, planes_eff, b0, b1)
        self.fused = DI._i32(rows, device)

        sa_src = sa_full if sa_full is not None else fm.suffix_array
        m = sa_src.shape[0]
        self.sa_local = -(-m // D)
        self.sa_start = r * self.sa_local
        a0, a1 = self.sa_start, min(self.sa_start + self.sa_local, m)
        # narrow: uint32 words; wide: int64 values (one column, no hi/lo pair)
        piece = np.zeros(self.sa_local, np.uint64 if wide else np.uint32)
        if a1 > a0:
            piece[:a1 - a0] = np.asarray(sa_src[a0:a1])
        self.sa = DI._i64(piece, device) if wide else DI._i32(piece, device)

        self.kmer_tbl = DI._i64(fm.kmer_count_table, device)
        self.count_arr = DI._i64(fm.count_array, device)
        self.sentinel = int(fm.sentinel_index)
        self.dense_lo = self.dense_hi = None
        if dk:
            d_lo, d_hi = dense_lut(fm, dk, wide=wide)
            up = DI._i64 if wide else DI._i32
            self.dense_lo, self.dense_hi = up(d_lo, device), up(d_hi, device)
        self.enc_table = DI._i64(DI._enc_table(fm), device)
        self.passthrough = DI.is_passthrough(fm)

    @property
    def n_devices(self) -> int:
        return self.mesh.n_ranks

    @property
    def dp_size(self) -> int:
        return self.mesh.size(self.dp_axis) if self.dp_axis else 1

    # ------------------------------------------------------------------
    def _fused_rows(self, q: torch.Tensor) -> torch.Tensor:
        """Fused rows of global blocks ``q``, in the narrow layout."""
        rows = _owned_gather(self.mesh.group(self.axis), self.fused, q, self.fused_start)
        return wide_rows(self.meta, rows) if self.meta.wide_pos else rows

    def _sa_at(self, idx: torch.Tensor) -> torch.Tensor:
        return u32(_owned_gather(self.mesh.group(self.axis), self.sa, idx, self.sa_start))

    def _local(self, arr) -> torch.Tensor:
        """This rank's rows of a full batch array: its ``dp_axis`` share, or
        all of it."""
        if self.dp_axis is not None:
            return distributed.shard_batch(self.mesh, arr, self.dp_axis)
        return torch.as_tensor(arr).to(self.mesh.device)

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """A per-dp-shard result, whole (the ranks of a shard group already
        agree)."""
        if self.dp_axis is None:
            return t
        return distributed.gather_rows(t, self.mesh.group(self.dp_axis))

    def _ranges(self, patterns, lens):
        """(lo, hi) of this rank's rows of the padded batch, and b."""
        patterns, lens, b = pad_batch(patterns, lens, self.dp_size,
                                      self.meta.sigma if self.passthrough else None)
        meta = self.meta
        # the trip count of the whole batch: every rank steps alike
        steps = search_ops.batch_facts(meta, lens, lens.size, patterns.shape[1])[0]
        sym = search_ops.encode_patterns(self.enc_table, self._local(patterns))
        my_lens = local_lens(self.mesh, lens, self.dp_axis)
        lo, hi, rem_steps, seed_len = search_ops.initial_range(
            meta, self.kmer_tbl, self.dense_lo, self.dense_hi, sym, my_lens)

        def rank(pos, s):
            q, rem = _split_pos(meta, self.sentinel, pos)
            return rank_from_rows(meta, self._fused_rows(q), rem, s)

        for t in range(steps):
            lo, hi = search_ops.lf_step(
                self.count_arr, rank, search_ops.sym_back(sym, my_lens, seed_len, t),
                lo, hi, (t < rem_steps) & (lo < hi))
        return lo, hi, b

    def count(self, patterns, lens=None) -> torch.Tensor:
        """counts int64 [b]."""
        lo, hi, b = self._ranges(patterns, lens)
        return self._gather(hi - lo)[:b]

    def pos_ranges(self, patterns, lens=None):
        """(lo, hi) int64 [b]."""
        lo, hi, b = self._ranges(patterns, lens)
        return self._gather(lo)[:b], self._gather(hi)[:b]

    def locate(self, patterns, lens=None, capacity: int | None = None):
        """(locs, pids, valid, dropped); with dp_axis, ``capacity`` is PER dp
        shard, the outputs are the shards' concatenated and pids are global
        batch indices (padding excluded via valid).  ``dropped`` counts
        per-dp-shard overflow beyond ``capacity`` (all zero when the capacity
        was auto-sized)."""
        lo, hi, b = self._ranges(patterns, lens)
        if capacity is None:
            counts = self._gather(hi - lo).cpu().numpy()
            capacity = shard_capacity(counts, b, self.dp_size)
        rows, pids, valid, dropped = locate_ops.expand_ranges(lo, hi, capacity)
        if self.dp_axis is not None:  # lift local pattern ids to global batch indices
            pids = pids + self.mesh.coord(self.dp_axis) * lo.shape[0]
        if self.meta.has_sa_full:
            locs = torch.where(valid, self._sa_at(rows), 0)
        else:
            # LF walk with collective gathers (locate/mod.rs:21-35); its loop
            # ends on the reduced state, the same on every rank of the group
            def decode(pos):
                q, rem = _split_pos(self.meta, self.sentinel, pos)
                rank, symidx = pre_rank_and_symidx_from_rows(
                    self.meta, self._fused_rows(q), rem)
                return rank, symidx, pos == self.sentinel - 1

            locs = locate_ops.lf_walk(self.meta.sampling_ratio, self.count_arr,
                                      self._sa_at, rows, valid, decode)
            locs = torch.where(valid, locs, 0)
        if self.dp_axis is not None:
            locs, pids, valid, dropped = distributed.gather_many(
                (locs, pids, valid, dropped), self.mesh.group(self.dp_axis))
        return locs, pids, valid & (pids < b), dropped
