"""Sharded batched queries: pattern data-parallelism over the ranks (port of
``sview_fmindex_tpu.parallel.query``).

- the index (a :class:`DeviceFmIndex`) is whole on every rank's device,
- every rank is handed the same full batch and keeps its own rows of it
  (the ``dp`` axis),
- each rank runs the normal engines on its rows (the join kernel runs on
  every rank; no communication on the hot path),
- results are gathered in rank order, so every rank returns the whole
  answer: shard after shard, as the JAX package's ``out_specs`` boundary
  concatenates them.

Results are int64 / bool tensors on the rank's device, as
``DeviceFmIndex`` returns them (wide indexes too: the JAX package's uint64
values).
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.device_index import DeviceFmIndex, check_symbols
from ..ops import locate as locate_ops
from ..ops import search as search_ops
from ..ops import wide as wide_ops
from . import distributed
from .mesh import DP_AXIS, make_mesh


def pad_batch(patterns, lens, n: int, passthrough_sigma: int | None = None):
    """The batch padded to a multiple of ``n`` lanes: (patterns uint8 [B, L],
    a tensor if one was given, else numpy; lens int32 [B] on the host, where
    the batch facts are taken; the unpadded count b).  Padded lanes get
    length 1 (a value the search can step) and are cut off by the callers.
    ``passthrough_sigma``: the alphabet size of a PassThrough index, whose
    batch is checked against it here, on every rank alike and before any
    collective (``device_index.check_symbols``)."""
    if isinstance(patterns, torch.Tensor):
        patterns = patterns.to(torch.uint8)
    else:
        patterns = np.asarray(patterns, dtype=np.uint8)
    if passthrough_sigma is not None:
        check_symbols(patterns, passthrough_sigma)
    if patterns.ndim == 1:
        patterns = patterns[None]
    if lens is None:
        lens = np.full(patterns.shape[0], patterns.shape[1], np.int32)
    elif isinstance(lens, torch.Tensor):
        lens = lens.cpu().numpy()
    lens = np.asarray(lens, dtype=np.int32).reshape(-1)
    b = patterns.shape[0]
    pad = (-b) % n
    if pad:
        if isinstance(patterns, torch.Tensor):
            patterns = torch.cat([patterns, patterns.new_zeros((pad, patterns.shape[1]))])
        else:
            patterns = np.concatenate([patterns, np.zeros((pad, patterns.shape[1]), np.uint8)])
        lens = np.concatenate([lens, np.ones(pad, np.int32)])
    return patterns, lens, b


def local_lens(mesh, lens: np.ndarray, axis: str | None) -> torch.Tensor:
    """This rank's lengths (its ``axis`` share of the padded batch, or all of
    it) as an int64 device tensor; one shared length is made on the device."""
    per = lens.shape[0] // (mesh.size(axis) if axis else 1)
    if lens.size and (lens == lens[0]).all():
        return torch.full((per,), int(lens[0]), dtype=torch.int64, device=mesh.device)
    lens = lens.astype(np.int64)
    if axis is None:
        return torch.as_tensor(lens, device=mesh.device)
    return distributed.shard_batch(mesh, lens, axis)


def shard_capacity(counts: np.ndarray, b: int, n_shards: int) -> int:
    """The capacity every shard expands into: the largest any shard needs,
    from the counts of ALL shards (padding lanes count nothing), so every
    rank arrives at the same number."""
    counts = counts.copy()
    counts[b:] = 0
    per_shard = counts.shape[0] // n_shards
    return max(locate_ops.expand_capacity(c, base=per_shard)
               for c in counts.reshape(n_shards, per_shard))


class ShardedFmIndex:
    """A DeviceFmIndex whole on every rank, queried pattern-data-parallel.
    Every rank makes the same calls with the same batch and gets the same
    answers."""

    def __init__(self, index: DeviceFmIndex, mesh=None, axis: str = DP_AXIS):
        self.mesh = mesh if mesh is not None else make_mesh(axis=axis)
        self.axis = axis
        self.index = distributed.replicate(self.mesh, index)

    @property
    def n_devices(self) -> int:
        return self.mesh.size(self.axis)

    # ------------------------------------------------------------------
    def _pad(self, patterns, lens):
        idx = self.index
        return pad_batch(patterns, lens, self.n_devices,
                         idx.meta.sigma if idx.passthrough else None)

    def _facts(self, lens, Lmax: int) -> tuple:
        """Host-side batch facts ``(steps, all_dense, fixed_len)``
        (``search.batch_facts``, as in device_index._as_batch), over the
        padded lengths: padding lanes have length 1, so all_dense only holds
        unpadded."""
        return search_ops.batch_facts(self.index.meta, lens, lens.size, Lmax)

    def _stream(self, B: int, use_stream: bool | None) -> bool:
        # the engine is chosen per shard: the crossover applies to a rank's
        # share of the batch
        return self.index._stream(B // self.n_devices, use_stream)

    def _ranges(self, patterns, lens, use_stream):
        """This rank's (lo, hi) over its rows of the padded batch, and
        whether the stream engine served them."""
        idx = self.index
        steps, all_dense, fixed_len = self._facts(lens, patterns.shape[1])
        stream = self._stream(patterns.shape[0], use_stream)
        my_pat = distributed.shard_batch(self.mesh, patterns, self.axis)
        my_lens = local_lens(self.mesh, lens, self.axis)
        sym = search_ops.encode_patterns(idx.enc_table, my_pat)
        if idx.meta.wide_pos:
            lo, hi = wide_ops.pos_ranges_wide(idx, sym, my_lens, steps, use_stream=stream,
                                              all_dense=all_dense, fixed_len=fixed_len)
        else:
            lo, hi = search_ops.pos_ranges(idx, sym, my_lens, steps, use_stream=stream,
                                           all_dense=all_dense, fixed_len=fixed_len)
        return lo, hi, stream

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        return distributed.gather_rows(t, self.mesh.group(self.axis))

    def count(self, patterns, lens, use_stream: bool | None = None) -> torch.Tensor:
        """counts int64 [b]."""
        patterns, lens, b = self._pad(patterns, lens)
        lo, hi, _ = self._ranges(patterns, lens, use_stream)
        return self._gather(hi - lo)[:b]

    def pos_ranges(self, patterns, lens, use_stream: bool | None = None):
        """(lo, hi) int64 [b]."""
        patterns, lens, b = self._pad(patterns, lens)
        lo, hi, _ = self._ranges(patterns, lens, use_stream)
        return self._gather(lo)[:b], self._gather(hi)[:b]

    def locate(self, patterns, lens, capacity_per_shard: int | None = None,
               use_stream: bool | None = None):
        """(locations, pattern_ids, valid, dropped) concatenated over shards,
        each of length ``n_shards * capacity``; pattern_ids are GLOBAL batch
        indices (padding lanes excluded via valid); ``dropped`` int64
        [n_shards] counts per-shard overflow occurrences beyond
        ``capacity_per_shard`` (all zero when the capacity was auto-sized).

        The backward search runs ONCE; with ``capacity_per_shard=None`` every
        shard's counts are gathered and the capacity is the largest any
        shard needs, so the gathered outputs agree in shape.
        """
        patterns, lens, b = self._pad(patterns, lens)
        lo, hi, stream = self._ranges(patterns, lens, use_stream)
        if capacity_per_shard is None:
            counts = self._gather(hi - lo).cpu().numpy()
            capacity_per_shard = shard_capacity(counts, b, self.n_devices)
        locs, pids, valid, dropped = self.index.resolve_rows(
            lo, hi, capacity_per_shard, stream)
        # lift local pattern ids to global batch indices
        pids = pids + self.mesh.coord(self.axis) * lo.shape[0]
        locs, pids, valid, dropped = distributed.gather_many(
            (locs, pids, valid, dropped), self.mesh.group(self.axis))
        return locs, pids, valid & (pids < b), dropped
