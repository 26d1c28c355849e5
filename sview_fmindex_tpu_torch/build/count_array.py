"""Count-array + k-mer lookup-table build pass.

Reproduces the semantics of ``CountArrayHeader::count_and_encode_text``
(``src/components/count_array.rs:78-145``) with vectorized numpy instead of
the reference's single reverse pass:

- the text is re-encoded in place to ``symidx + 1`` (sentinel reserves 0),
- ``count_array[v]`` accumulates occurrences of encoded value v, then is
  prefix-summed (so ``count_array[i]`` = #symbols with index < i),
- the k-mer table counts, for every text position p, the base-(sigma+1)
  number formed by ``enc[p..p+k)`` with past-end digits = 0 (the reference's
  rolling ``table_index`` walked right-to-left computes exactly this), then
  is prefix-summed.
"""
from __future__ import annotations

import numpy as np

_CHUNK = 1 << 24


def encode_text(text: np.ndarray, table: np.ndarray | None) -> np.ndarray:
    """raw bytes -> symidx+1 (uint8).  ``table=None`` means PassThrough."""
    if table is None:
        return text + np.uint8(1)
    return table[text] + np.uint8(1)


def count_and_kmer_tables(
    enc_plus1: np.ndarray, symbol_count: int, kmer_size: int
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (count_array, kmer_count_table) both prefix-summed, as uint64.

    ``enc_plus1`` holds values in [1, sigma].
    """
    sigma = symbol_count
    base = sigma + 1
    n = len(enc_plus1)

    counts = np.bincount(enc_plus1, minlength=base)[:base].astype(np.uint64)
    count_array = np.cumsum(counts, dtype=np.uint64)

    table_len = base**kmer_size
    kmer_counts = np.zeros(table_len, dtype=np.int64)
    # k-mer index per position, chunked to bound memory at Gbp scale.
    padded = np.concatenate(
        [enc_plus1.astype(np.int64, copy=False), np.zeros(kmer_size - 1, np.int64)]
    ) if kmer_size > 1 else enc_plus1.astype(np.int64, copy=False)
    for start in range(0, n, _CHUNK):
        stop = min(start + _CHUNK, n)
        idx = np.zeros(stop - start, dtype=np.int64)
        for i in range(kmer_size):
            idx *= base
            idx += padded[start + i : stop + i]
        kmer_counts += np.bincount(idx, minlength=table_len)
    kmer_table = np.cumsum(kmer_counts, dtype=np.uint64)
    return count_array, kmer_table


def kmer_multiplier(symbol_count: int, kmer_size: int) -> np.ndarray:
    """[(sigma+1)^(k-1), ..., (sigma+1), 1]  (``count_array.rs:89-93``)."""
    base = symbol_count + 1
    return np.array([base ** (kmer_size - 1 - i) for i in range(kmer_size)], dtype=np.uint64)
