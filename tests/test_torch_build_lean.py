"""The port's host build in pieces (``build/{count_array,bwt,bwm}.py``,
``models/builder.py``) against the JAX package's builder, which takes every
pass over the whole text at once.

- Blobs byte-identical to the JAX builder's with the chunk constant of every
  pass patched to small odd values, so that chunk edges fall inside k-mer
  windows, sampled-SA strides, the sentinel row of the BWT and the blocks:
  u32 and u64 positions, SA sampling 1-3, k-mer sizes 1-3, DNA, protein and
  PassThrough alphabets, text lengths a multiple of the block length, one
  under and one over (the exactly-full text takes the extra all-zero block).
- The build's ``tracemalloc`` peak at 4e6 bp into a preallocated blob: at
  most 11 bytes per bp with the native SA-IS's int64 entry (what a text of
  2^31 bp or more takes) and at most 7 with its int32 entry.
"""
import ctypes
import random
import tracemalloc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sview_fmindex_tpu as fmx  # noqa: E402
import sview_fmindex_tpu_torch as ft  # noqa: E402
from sview_fmindex_tpu_torch.build import bwm, bwt, count_array  # noqa: E402
from sview_fmindex_tpu_torch.native import loader  # noqa: E402

AMINO = b"ARNDCQEGHILKMFPSTWYV"
# alphabet -> (symbols or None for PassThrough, sigma, (planes, vector bits))
ALPHABETS = {
    "dna": ([b"A", b"C", b"G", b"T"], 4, (3, 64)),
    "protein": ([bytes([c]) for c in AMINO], 20, (5, 128)),
    "pass": (None, 6, (3, 32)),
}
BLOCKS_IN_TEXT = 37
RATIO_K = [(r, k) for r in (1, 2, 3) for k in (1, 2, 3)]
PEAK_BP = 4_000_000


def _text(alphabet: str, n: int) -> bytes:
    symbols, sigma, _ = ALPHABETS[alphabet]
    rng = random.Random(n * 7 + sigma)
    if symbols is None:
        return bytes(rng.randrange(sigma) for _ in range(n))
    pool = b"".join(symbols)
    return bytes(rng.choice(pool) for _ in range(n))


def _builder(pkg, alphabet: str, n: int, position: str, r: int, k: int):
    """r=1 is the uncompressed SA, k=1 no k-mer table (the configs refuse
    ``compressed(1)`` and ``kmer_size(1)``)."""
    symbols, sigma, block = ALPHABETS[alphabet]
    enc = pkg.PassThrough() if symbols is None else pkg.EncodingTable.from_symbols(symbols)
    return pkg.FmIndexBuilder(
        n, sigma, enc, position=position, block=pkg.BlockKind(*block),
        suffix_array_config=(pkg.SuffixArrayConfig.compressed(r) if r > 1
                             else pkg.SuffixArrayConfig.uncompressed()),
        lookup_table_config=(pkg.LookupTableConfig.kmer_size(k) if k > 1
                             else pkg.LookupTableConfig.none()))


@pytest.mark.parametrize("chunk", (7, 1000))
@pytest.mark.parametrize("edge", (-1, 0, 1), ids=("under", "multiple", "over"))
@pytest.mark.parametrize("position", ("u32", "u64"))
@pytest.mark.parametrize("alphabet", tuple(ALPHABETS))
@pytest.mark.parametrize("r,k", RATIO_K, ids=[f"r{r}k{k}" for r, k in RATIO_K])
def test_blob_byte_identical_at_every_chunk_edge(monkeypatch, alphabet, position, edge,
                                                 chunk, r, k):
    n = BLOCKS_IN_TEXT * ALPHABETS[alphabet][2][1] + edge
    for mod in (count_array, bwt, bwm):
        monkeypatch.setattr(mod, "_CHUNK", chunk)
    text = _text(alphabet, n)
    want = bytes(_builder(fmx, alphabet, n, position, r, k).build(text))
    b = _builder(ft, alphabet, n, position, r, k)
    assert b.build(text) == want
    # into a preallocated buffer holding garbage: the same bytes
    out = np.full(b.blob_size(), 0xA5, np.uint8)
    assert b.build(text, blob=out) is out
    assert out.tobytes() == want


def _sa_int64_entry(s: np.ndarray) -> np.ndarray:
    """The native SA-IS through its int64 entry, whatever the length: the
    SA a text of 2^31 bp or more gets (8 bytes per position)."""
    lib = loader._load()
    sa = np.empty(len(s), np.int64)
    rc = lib.sview_sais_u8(s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                           sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                           ctypes.c_int64(len(s)))
    assert rc == 0
    return sa


@pytest.fixture(scope="module")
def peak_text():
    rng = np.random.default_rng(11)
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, PEAK_BP)].tobytes()


def _peak(text: bytes, position: str) -> tuple[float, bytes]:
    enc = ft.EncodingTable.from_symbols([b"A", b"C", b"G", b"T"])
    b = ft.FmIndexBuilder(len(text), 4, enc, position=position, block=ft.BLOCK3_U64,
                          suffix_array_config=ft.SuffixArrayConfig.compressed(2),
                          lookup_table_config=ft.LookupTableConfig.kmer_size(3),
                          sa_backend="native")
    out = np.zeros(b.blob_size(), np.uint8)
    tracemalloc.start()
    try:
        b.build(text, blob=out)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    return peak / len(text), out.tobytes()


@pytest.mark.parametrize("position,sa_entry,limit", [
    ("u64", "int64", 11.0), ("u32", "int32", 7.0)])
def test_build_peak_bytes_per_bp(monkeypatch, peak_text, position, sa_entry, limit):
    if not loader.available():
        pytest.skip("the native SA-IS library did not build")
    if sa_entry == "int64":
        _, want = _peak(peak_text, position)
        monkeypatch.setattr(loader, "suffix_array", _sa_int64_entry)
    per_bp, blob = _peak(peak_text, position)
    assert per_bp <= limit, f"{per_bp:.2f} bytes per bp"
    if sa_entry == "int64":
        assert blob == want  # the int64 SA writes the same blob
