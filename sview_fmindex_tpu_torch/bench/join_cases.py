"""Ragged-edge key sets for the join kernel, shared by the CPU tests, the
card tests and the smoke run.

The kernel hands 32 consecutive keys to a warp and 128 to a block, finds the
distinct rows among a warp's keys by comparing neighbours, and fetches them
together; no lane may leave before its warp's last shuffle and copy.  These
sets put every edge of that scheme inside a warp: a key count that is no
multiple of 32 or 128, a single key, keys outside the table among valid
ones, all keys in one row, a run of one row across warp boundaries, segment
boundaries, and keys in no order at all (the answer must not depend on it).
"""
from __future__ import annotations

import numpy as np

SBL = 128  # positions per table row

RAGGED_CASES = [
    "one_key", "n31", "n33", "n127", "n129", "one_row", "equal_keys", "run_across_warps",
    "outside_at_both_ends", "outside_inside_a_warp", "all_outside", "segment_edges", "unsorted",
]


def ragged_keys(case: str, n_rows: int, seg_rows: int, seed: int = 0) -> np.ndarray:
    """int64 keys of ``case`` for a table of ``n_rows`` rows cut into
    segments of ``seg_rows`` rows (``n_rows`` >= 2 * ``seg_rows`` >= 16)."""
    rng = np.random.default_rng(seed)
    end = n_rows * SBL  # the first key past the table

    def inside(n: int) -> np.ndarray:
        return np.sort(rng.integers(0, end, size=n))

    if case == "one_key":
        return np.array([5 * SBL + 3], np.int64)
    if case in ("n31", "n33", "n127", "n129"):
        return inside(int(case[1:]))
    if case == "one_row":  # every position of row 7, then some twice
        return np.sort(np.concatenate([7 * SBL + np.arange(SBL), 7 * SBL + rng.integers(
            0, SBL, size=72)]))
    if case == "equal_keys":
        return np.full(50, 3 * SBL + 77, np.int64)
    if case == "run_across_warps":  # 70 keys of one row from lane 20 of warp 0 into warp 2
        row = n_rows // 2
        return np.concatenate([np.sort(rng.integers(0, row * SBL, size=20)),
                               np.sort(row * SBL + rng.integers(0, SBL, size=70)),
                               np.sort(rng.integers((row + 1) * SBL, end, size=40))])
    if case == "outside_at_both_ends":
        return np.concatenate([[-(2**40), -SBL, -1], inside(58), [end, end + 1, 2**45]])
    if case == "outside_inside_a_warp":  # every third key is outside, its neighbours share rows
        keys = np.repeat(inside(32), 3)
        keys[1::3] = np.where(np.arange(32) % 2 == 0, -1 - np.arange(32), end + np.arange(32))
        return keys
    if case == "all_outside":
        return np.concatenate([-1 - np.arange(20), end + np.arange(20)])
    if case == "segment_edges":  # both sides of every segment boundary, in one warp each
        edges = np.arange(seg_rows, n_rows, seg_rows) * SBL
        return np.sort(np.concatenate([edges - 1, edges, edges + 1, edges + SBL,
                                       [0, end - 1, end], inside(17)]))
    if case == "unsorted":
        return rng.permutation(np.concatenate([inside(150), [-5, end, end + 9]]))
    raise ValueError(f"unknown ragged case {case!r}")
