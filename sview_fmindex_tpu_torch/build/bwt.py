"""BWT + sampled suffix array, matching the reference's sentinel conventions.

Mirrors ``get_compressed_suffix_array_and_pidx_while_bwt_with_crate_bio``
(``crate_bio_manual/mod.rs:8-32``):

1. append sentinel 0 to the encoded text (values 1..sigma),
2. SA over text+sentinel (SA[0] == n, the sentinel-only suffix),
3. BWT[r] = input[SA[r]-1] (wrapping: SA[r]==0 -> sentinel),
4. pidx = row where BWT == 0; remove it from BWT; drop SA[0],
5. sampled SA = remaining SA taken every ``sampling_ratio`` steps.

The SA is the one array of 4 or 8 bytes per position; every pass over it
runs in pieces of ``_CHUNK`` rows and writes straight into its result, so
the build's peak is the SA, the padded text and the BWT.
"""
from __future__ import annotations

import numpy as np

from .suffix_array import suffix_array

_CHUNK = 1 << 18


def padded_text(n: int) -> np.ndarray:
    """uint8 [n + 2] for an encoded text of ``n`` symbols: ``[1:n+1]`` takes
    the text, both ends hold the sentinel 0.  ``[1:]`` is the
    sentinel-terminated input of the SA, and ``[SA[r]]`` is BWT row r's
    symbol (SA[r] == 0 reads the leading 0: the wrapped sentinel)."""
    buf = np.empty(n + 2, dtype=np.uint8)
    buf[0] = buf[n + 1] = 0
    return buf


def bwt_and_sampled_sa(
    padded: np.ndarray, sampling_ratio: int, sampled_out: np.ndarray,
    sa_backend: str | None = None, sa_full_path: str | None = None,
) -> tuple[np.ndarray, int]:
    """Returns (bwt_without_sentinel uint8 [n], pidx); the sampled SA is
    written into ``sampled_out`` ([ceil(n / sampling_ratio)], the blob's
    position type).  ``padded``: :func:`padded_text` holding the encoded
    text.

    ``sa_full_path``: optionally persist the FULL (unsampled, sentinel-row-
    dropped) suffix array as little-endian uint32 — the device engine can use
    it as a derived r=1 locate cache (``models/device_index.py``), the same
    way the dense k-mer LUT memoizes the search seed.  It is free here: the
    full SA exists before sampling anyway.
    """
    n = len(padded) - 2
    if sa_full_path is not None and n >= 2**32:
        raise ValueError(
            "sa_full_path stores little-endian uint32 positions; "
            f"text_len {n} >= 2^32 would truncate — omit sa_full_path "
            "for u64-position builds")
    sa = suffix_array(padded[1:], backend=sa_backend)
    bwt = np.empty(n, dtype=np.uint8)
    pidx = -1
    for a in range(0, n + 1, _CHUNK):
        b = min(a + _CHUNK, n + 1)
        piece = np.take(padded, sa[a:b], mode="clip")
        if pidx >= 0:  # rows after the sentinel row move up by one
            bwt[a - 1 : b - 1] = piece
            continue
        hit = np.flatnonzero(sa[a:b] == 0)
        if not hit.size:
            bwt[a:b] = piece
            continue
        z = int(hit[0])
        pidx = a + z
        bwt[a:pidx] = piece[:z]
        bwt[pidx : b - 1] = piece[z + 1 :]
    rows = sa[1:]  # SA[0] is the sentinel-only suffix
    m = len(sampled_out)
    for j in range(0, m, _CHUNK):
        k = min(j + _CHUNK, m)
        sampled_out[j:k] = rows[j * sampling_ratio : (k - 1) * sampling_ratio + 1 : sampling_ratio]
    if sa_full_path is not None:
        with open(sa_full_path, "wb") as f:
            for a in range(0, n, _CHUNK):
                rows[a : a + _CHUNK].astype("<u4").tofile(f)
    return bwt, pidx
