"""BWT + sampled suffix array, matching the reference's sentinel conventions.

Mirrors ``get_compressed_suffix_array_and_pidx_while_bwt_with_crate_bio``
(``crate_bio_manual/mod.rs:8-32``):

1. append sentinel 0 to the encoded text (values 1..sigma),
2. SA over text+sentinel (SA[0] == n, the sentinel-only suffix),
3. BWT[r] = input[SA[r]-1] (wrapping: SA[r]==0 -> sentinel),
4. pidx = row where BWT == 0; remove it from BWT; drop SA[0],
5. sampled SA = remaining SA taken every ``sampling_ratio`` steps.
"""
from __future__ import annotations

import numpy as np

from .suffix_array import suffix_array


def bwt_and_sampled_sa(
    enc_plus1: np.ndarray, sampling_ratio: int, sa_backend: str | None = None,
    sa_full_path: str | None = None,
) -> tuple[np.ndarray, int, np.ndarray]:
    """Returns (bwt_without_sentinel uint8, pidx, sampled_sa int64).

    ``sa_full_path``: optionally persist the FULL (unsampled, sentinel-row-
    dropped) suffix array as little-endian uint32 — the device engine can use
    it as a derived r=1 locate cache (``models/device_index.py``), the same
    way the dense k-mer LUT memoizes the search seed.  It is free here: the
    full SA exists before sampling anyway.
    """
    n = len(enc_plus1)
    with_sentinel = np.empty(n + 1, dtype=np.uint8)
    with_sentinel[:n] = enc_plus1
    with_sentinel[n] = 0
    sa = suffix_array(with_sentinel, backend=sa_backend)
    # BWT: predecessor of each suffix; SA[r]==0 wraps to the sentinel, which
    # conveniently is with_sentinel[-1].
    bwt = with_sentinel[sa - 1]
    pidx_rows = np.nonzero(bwt == 0)[0]
    pidx = int(pidx_rows[0])
    bwt_wo = np.delete(bwt, pidx)
    if sa_full_path is not None:
        if n >= 2**32:
            raise ValueError(
                "sa_full_path stores little-endian uint32 positions; "
                f"text_len {n} >= 2^32 would truncate — omit sa_full_path "
                "for u64-position builds")
        sa[1:].astype("<u4", copy=False).tofile(sa_full_path)
    sampled_sa = sa[1:][::sampling_ratio].astype(np.int64, copy=False)
    return bwt_wo, pidx, sampled_sa
