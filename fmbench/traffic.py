"""The pool of batches a traffic mix sends, made from the run's seed.

One generator reads the mix's file (``traffic/<mix>.json``):

- ``op``: ``"locate"`` (``locate_with_counts``) or ``"count"``;
- ``batch``: patterns per call; ``pool``: distinct batches, sent in turn;
- ``lengths``: ``[lo, hi]``, each pattern's length uniform in it.  Patterns
  are windows of the text; a batch is padded with zero bytes to ``hi`` and
  sent with its lengths unless every length is the same;
- ``distinct_starts``: no two patterns of the pool start at one position;
- ``to_host``: each call's results are copied to the host before the next
  call starts (the caller reads every answer), else the call ends with a
  device synchronisation.

The batches are CPU tensors, as a caller holds them: the copy of the batch
to the card is part of each call.
"""
from __future__ import annotations

import numpy as np
import torch


def draw_starts(rng: np.random.Generator, count: int, high: int, distinct: bool) -> np.ndarray:
    """``count`` starts in [0, high), in random order; all different when
    ``distinct``."""
    if not distinct:
        return rng.integers(0, high, size=count)
    if count > high:
        raise ValueError(f"{count} distinct starts asked of {high}")
    # sort and drop repeats: numpy 2.3's np.unique hashes, and took 14-17 s
    # on 9.4M int64 where this takes a fifth of a second
    got = np.empty(0, np.int64)
    while got.size < count:
        more = rng.integers(0, high, size=count - got.size + count // 8 + 16)
        got = np.sort(np.concatenate([got, more]))
        got = got[np.concatenate([[True], got[1:] != got[:-1]])]
    rng.shuffle(got)
    return got[:count]


def make_pool(text: np.ndarray, mix: dict, rng: np.random.Generator) -> list:
    """[(patterns uint8 [B, hi] CPU tensor, lens int32 [B] CPU tensor or
    None)] * pool."""
    B, pool = int(mix["batch"]), int(mix["pool"])
    lo, hi = (int(x) for x in mix["lengths"])
    starts = draw_starts(rng, B * pool, text.shape[0] - hi + 1,
                         bool(mix.get("distinct_starts")))
    windows = np.lib.stride_tricks.sliding_window_view(text, hi)
    cols = np.arange(hi)
    out = []
    for i in range(pool):
        pats = windows[starts[i * B:(i + 1) * B]]
        if lo == hi:
            out.append((torch.from_numpy(pats), None))
            continue
        lens = rng.integers(lo, hi + 1, size=B).astype(np.int32)
        pats[cols[None, :] >= lens[:, None]] = 0
        out.append((torch.from_numpy(pats), torch.from_numpy(lens)))
    return out
