"""Suffix-array construction backends.

The reference has two swappable backends selected at compile time
(``src/components/suffix_array/burrow_wheeler_transform/mod.rs:1-13``):
a vendored rust-bio SA-IS (default) and libdivsufsort via C FFI (feature
``fastbwt``).  We mirror that dual-backend design:

- :func:`suffix_array_numpy` — portable prefix-doubling (numpy argsort),
  always available; O(n log^2 n)-ish, fine up to tens of Mbp.
- the native C++ SA-IS extension (``sview_fmindex_tpu_torch/native``) — linear
  time, used automatically when the shared library is built.

Both take the sentinel-terminated encoded text (values in [0, sigma], the
single 0 sentinel at the end) and return the full suffix array, exactly as
the reference builds SA over ``text + [0]``
(``crate_bio_manual/mod.rs:8-23``).
"""
from __future__ import annotations

import os

import numpy as np

from ..native import loader as _native_loader


def suffix_array_numpy(s: np.ndarray) -> np.ndarray:
    """Prefix-doubling suffix array of ``s`` (int array, sentinel-terminated).

    Returns int64 suffix array of length len(s).
    """
    n = len(s)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    rank = np.asarray(s, dtype=np.int64)
    sa = np.argsort(rank, kind="stable")
    # compress ranks
    sorted_ranks = rank[sa]
    new_rank = np.zeros(n, dtype=np.int64)
    new_rank[sa] = np.cumsum(np.concatenate([[0], (sorted_ranks[1:] != sorted_ranks[:-1]).astype(np.int64)]))
    rank = new_rank

    k = 1
    while k < n:
        if rank[sa[-1]] == n - 1:  # all distinct
            break
        # second key: rank of suffix i+k (or -1 if past end)
        second = np.full(n, -1, dtype=np.int64)
        second[: n - k] = rank[k:]
        order = np.lexsort((second, rank))
        sa = order
        key1 = rank[sa]
        key2 = second[sa]
        changed = np.concatenate(
            [[0], ((key1[1:] != key1[:-1]) | (key2[1:] != key2[:-1])).astype(np.int64)]
        )
        new_rank = np.empty(n, dtype=np.int64)
        new_rank[sa] = np.cumsum(changed)
        rank = new_rank
        k *= 2
    return sa.astype(np.int64)


def suffix_array(s: np.ndarray, backend: str | None = None) -> np.ndarray:
    """Suffix array of the sentinel-terminated text ``s``.

    ``backend``: 'native' (C++ SA-IS), 'numpy', or None for auto
    (native when built, else numpy; override with SVIEW_FMINDEX_SA_BACKEND).
    """
    backend = backend or os.environ.get("SVIEW_FMINDEX_SA_BACKEND")
    if backend is None:
        backend = "native" if _native_loader.available() else "numpy"
    if backend == "native":
        return _native_loader.suffix_array(np.ascontiguousarray(s, dtype=np.uint8))
    if backend == "numpy":
        return suffix_array_numpy(s)
    raise ValueError(f"unknown suffix array backend: {backend!r}")
