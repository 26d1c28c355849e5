"""Count-array + k-mer lookup-table build pass.

Reproduces the semantics of ``CountArrayHeader::count_and_encode_text``
(``src/components/count_array.rs:78-145``) with vectorized numpy instead of
the reference's single reverse pass:

- the text is re-encoded to ``symidx + 1`` (sentinel reserves 0),
- ``count_array[v]`` accumulates occurrences of encoded value v, then is
  prefix-summed (so ``count_array[i]`` = #symbols with index < i),
- the k-mer table counts, for every text position p, the base-(sigma+1)
  number formed by ``enc[p..p+k)`` with past-end digits = 0 (the reference's
  rolling ``table_index`` walked right-to-left computes exactly this), then
  is prefix-summed.

Every pass over the text runs in pieces of ``_CHUNK`` positions, so no
temporary grows with the text (numpy widens a uint8 index or count input
to 8 bytes per element).
"""
from __future__ import annotations

import numpy as np

_CHUNK = 1 << 18


def encode_text(text: np.ndarray, table: np.ndarray | None,
                out: np.ndarray | None = None) -> np.ndarray:
    """raw bytes -> symidx+1 (uint8), written into ``out`` (a new array if
    None).  ``table=None`` means PassThrough."""
    n = len(text)
    out = np.empty(n, np.uint8) if out is None else out
    plus1 = None if table is None else table + np.uint8(1)
    for a in range(0, n, _CHUNK):
        b = min(a + _CHUNK, n)
        if plus1 is None:
            np.add(text[a:b], np.uint8(1), out=out[a:b])
        else:
            np.take(plus1, text[a:b], out=out[a:b], mode="clip")
    return out


def count_and_kmer_tables(
    enc_plus1: np.ndarray, symbol_count: int, kmer_size: int
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (count_array, kmer_count_table) both prefix-summed, as uint64.

    ``enc_plus1`` holds values in [1, sigma].
    """
    base = symbol_count + 1
    n = len(enc_plus1)
    table_len = base**kmer_size
    counts = np.zeros(base, dtype=np.int64)
    kmer_counts = np.zeros(table_len, dtype=np.int64)
    for start in range(0, n, _CHUNK):
        stop = min(start + _CHUNK, n)
        counts += np.bincount(enc_plus1[start:stop], minlength=base)[:base]
        idx = np.zeros(stop - start, dtype=np.int64)
        for i in range(kmer_size):
            idx *= base
            digits = enc_plus1[start + i : stop + i]  # past-end digits are 0
            idx[: len(digits)] += digits
        kmer_counts += np.bincount(idx, minlength=table_len)
    count_array = np.cumsum(counts, dtype=np.uint64)
    kmer_table = np.cumsum(kmer_counts, dtype=np.uint64)
    return count_array, kmer_table


def kmer_multiplier(symbol_count: int, kmer_size: int) -> np.ndarray:
    """[(sigma+1)^(k-1), ..., (sigma+1), 1]  (``count_array.rs:89-93``)."""
    base = symbol_count + 1
    return np.array([base ** (kmer_size - 1 - i) for i in range(kmer_size)], dtype=np.uint64)
