"""Spans and counters of the query path, live only while ``torch.profiler``
records.

- :func:`span` enters ``torch.profiler.record_function`` while a profiler
  records, so the query path's layers land in the profiler's own timeline
  beside the device's kernels, copies and memsets, on one clock.  At all
  other times it is a no-op that costs one flag read.
- :data:`COUNTS` holds what the query path counts while a profiler records
  (:func:`count`): exactly the traced window, nothing before or after it.

Spans (``models/device_index.py``): ``fmindex.locate`` and ``fmindex.count``
cover a whole call; inside them ``fmindex.intake`` (the batch put on the
index's device, its host facts), ``fmindex.search`` (encode, seed, every
pass of every engine), ``fmindex.capacity`` (two sums of the counts reduced
on the device and read on the host to size the locate buffer) and
``fmindex.resolve`` (expand, then the SA gather or the LF walk); the LF walk
opens ``fmindex.walk``, inside ``fmindex.resolve`` where a call walks: on a
card the launch of ``csrc/lf_walk.cu`` and the read of its counts
(``ops/locate.walk_rows_cuda``), else the plain walk's steps and the final
read of the sampled SA (``ops/locate.lf_walk``).

Counters: ``calls`` (``count`` and ``locate_with_counts`` calls),
``intake_bytes`` (the batch's patterns, and its lengths where the caller
gave them, as they sit on the index's device), ``syncs`` (each point
where the host waits for a value held on the device: the capacity read,
each step test of the plain LF walk, the one read of the walk kernel's
counts, lengths or a PassThrough batch handed in on the index's device) and
``intake_scans`` (batches whose host facts were read from per-lane lengths;
a batch without lengths adds 0, so the key is there whenever a call was
counted), and in ``locate_with_counts`` ``rows`` (the rows located: the sum
of the counts, one of the two sums the capacity read brings to the host; not
counted where the caller passes ``capacity``, since then nothing is read)
and ``slots`` (the expand buffer's capacity, a host int on both paths), and
in ``ops/locate.device_capacity`` ``capacity_bytes`` (the bytes that
capacity read copies to the host: 16, the two int64 sums; none where the
caller passes ``capacity``), and in ``ops/search.gather_ranges_cuda``
``gather_kernel`` (1 for each launch of the gather engine's CUDA kernel,
counted where ``LAUNCHES["gather"]`` is), and in ``ops/locate.walk_rows_cuda``
``walk_kernel`` (1 for each launch of the LF walk's CUDA kernel, counted
where ``LAUNCHES["walk"]`` is in ``ops/locate``), and the walk's three keys,
all from 0 whenever a walk ran: ``walk_row_steps`` (the LF steps the located
rows take, one decode each, up to and including the sentinel's: fixed by
the index and not by the implementation; the plain walk sums its live rows
over its steps, the kernel its decodes over its rows), ``walk_steps`` (the
most any row takes: the plain walk's steps, one decode launch each; the
kernel reads the longest row's) and ``walk_lanes`` (the lanes decoded,
summed: the plain walk sends the whole row buffer each step, the kernel one
decode a row step, so there it equals ``walk_row_steps``).
"""
from __future__ import annotations

import collections
import contextlib

import torch
from torch.autograd import profiler as _autograd_profiler

COUNTS: collections.Counter = collections.Counter()

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: ``record_function(name)`` while a profiler
    records, else nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def recording() -> bool:
    """Whether a profiler records."""
    return _autograd_profiler._is_profiler_enabled


def count(key: str, n: int = 1) -> None:
    """Add ``n`` to ``COUNTS[key]`` while a profiler records."""
    if _autograd_profiler._is_profiler_enabled:
        COUNTS[key] += n
