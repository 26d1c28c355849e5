"""The join kernel against its plain version (sview_fmindex_tpu_torch/csrc/join.cu).

On the CPU, ``join_plain`` is held against a scalar Python statement of the
kernel's contract on random table words (every bit pattern, payloads up to
63, keys past the table, random padding words between checkpoints and
planes), in the plain and the segmented modes, at sigma 2 to 63: the
main path's 4 and 16 and every plane count and row padding.  On a card (``@pytest.mark.cuda``; skipped
without one) the CUDA kernel must equal ``join_plain`` exactly, and the
whole slice on CUDA must equal the CPU run.  The ragged-edge key sets of
``bench/join_cases.py`` (key counts off the warp and block size, keys
outside the table inside a warp, one row for many keys, segment boundaries,
unsorted keys) go through ``join_plain`` against the scalar contract here and
through the kernel against ``join_plain`` on a card, in all four modes, at a
sigma whose rows are staged whole and one whose planes alone are.  This file
imports no JAX, so on
a machine without it the card tests run with
``python -m pytest tests/test_torch_kernels.py -m cuda --noconftest``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import sview_fmindex_tpu_torch as ft  # noqa: E402
from sview_fmindex_tpu_torch.bench.join_cases import RAGGED_CASES, ragged_keys  # noqa: E402
from sview_fmindex_tpu_torch.ops import stream_join as sj  # noqa: E402


def _scalar_join(tbl, key, payload, sigma, decode, seg_base=None, seg_shift=0):
    """The kernel's contract, one query at a time in Python integers."""
    P = max(1, (sigma - 1).bit_length())
    off = sj._plane_off(sigma)  # planes start after the checkpoint's padding
    blk = key >> 7
    if key < 0 or blk >= tbl.shape[0]:
        return 0, 0
    w = [int(x) & 0xFFFFFFFF for x in tbl[blk]]
    assert len(w) == off + 4 * P
    rem = key & 127
    if decode:
        lane, bit = rem >> 5, 31 - (rem & 31)
        sym = sum(((w[off + q * 4 + lane] >> bit) & 1) << q for q in range(P))
    else:
        sym = payload & 63
    cnt = 0
    for lane in range(4):
        comb = 0xFFFFFFFF
        for q in range(P):
            wq = w[off + q * 4 + lane]
            comb &= wq if (sym >> q) & 1 else ~wq & 0xFFFFFFFF
        take = min(max(rem - 32 * lane, 0), 32)
        cnt += bin(comb & ((0xFFFFFFFF << (32 - take)) & 0xFFFFFFFF if take else 0)).count("1")
    base = int(seg_base[blk >> seg_shift, sym]) if seg_base is not None and sym < sigma else 0
    return (w[sym] if sym < sigma else 0) + cnt + base, sym


def _random_case(sigma, n_rows, n_keys, seed, seg_shift=None):
    """Random table words, sorted keys (some past the table), payloads up
    to 63; with ``seg_shift`` also random segment bases up to 2^35."""
    rng = np.random.default_rng(seed)
    tbl = rng.integers(-2**31, 2**31, size=(n_rows, sj._rw(sigma))).astype(np.int32)
    key = np.sort(rng.integers(0, n_rows * 128 + 200, size=n_keys))
    payload = rng.integers(0, 64, size=n_keys)
    seg_base = None
    if seg_shift is not None:
        seg_base = rng.integers(0, 2**35, size=(-(-n_rows >> seg_shift), sigma))
    return tbl, key, payload, seg_base


# the main path's sigma 4 and 16, then each plane count (1-6) and row
# padding (the checkpoint words before the planes): 2 (4 words), 3 (8, the
# 64-byte row), 5 and 7 (wildcard DNA; 8 words), 9 (the pass-through corpus
# alphabet; 16 words, the 128-byte row), 20 (protein; no padding), 25 (a
# pair table; 28 words), 49 (the largest pair table) and 63 (the largest
# alphabet)
SIGMAS = [4, 16, 2, 3, 5, 7, 9, 20, 25, 49, 63]
MODES = [(s, d) for s in SIGMAS for d in (False, True)]


@pytest.mark.parametrize("segmented", [False, True], ids=["plain", "seg"])
@pytest.mark.parametrize("sigma,decode", MODES)
def test_join_plain_matches_scalar_contract(sigma, decode, segmented):
    shift = 3 if segmented else None  # 8-row segments: 5 of them
    tbl, key, payload, seg_base = _random_case(sigma, 40, 1500, sigma + decode, shift)
    rank, sym = sj.join_plain(torch.from_numpy(tbl), torch.from_numpy(key),
                              None if decode else torch.from_numpy(payload), sigma, decode,
                              None if seg_base is None else torch.from_numpy(seg_base), shift)
    assert (sym is None) == (not decode)
    for i in range(key.shape[0]):
        want_rank, want_sym = _scalar_join(tbl, int(key[i]), int(payload[i]), sigma, decode,
                                           seg_base, shift or 0)
        assert int(rank[i]) == want_rank, i
        if decode:
            assert int(sym[i]) == want_sym, i


RAGGED_ROWS, RAGGED_SEG_SHIFT = 40, 3  # 5 segments of 8 rows
# (sigma, decode, segmented): rows staged whole (sigma 4) and planes only (20)
RAGGED_MODES = [(s, d, g) for s in (4, 20) for d in (False, True) for g in (False, True)]
RAGGED_IDS = [f"sigma{s}-{'decode' if d else 'rank'}{'_seg' if g else ''}"
              for s, d, g in RAGGED_MODES]


def _ragged_case(case, sigma, decode, segmented):
    seed = RAGGED_CASES.index(case) * 8 + sigma + 2 * decode + segmented
    tbl, _, _, seg_base = _random_case(sigma, RAGGED_ROWS, 1, seed,
                                       RAGGED_SEG_SHIFT if segmented else None)
    key = ragged_keys(case, RAGGED_ROWS, 1 << RAGGED_SEG_SHIFT, seed)
    payload = np.random.default_rng(seed).integers(0, 64, size=key.shape[0])
    return tbl, key, payload, seg_base


@pytest.mark.parametrize("sigma,decode,segmented", RAGGED_MODES, ids=RAGGED_IDS)
@pytest.mark.parametrize("case", RAGGED_CASES)
def test_join_plain_ragged_edges(case, sigma, decode, segmented):
    tbl, key, payload, seg_base = _ragged_case(case, sigma, decode, segmented)
    rank, sym = sj.join_plain(torch.from_numpy(tbl), torch.from_numpy(key),
                              None if decode else torch.from_numpy(payload), sigma, decode,
                              None if seg_base is None else torch.from_numpy(seg_base),
                              RAGGED_SEG_SHIFT)
    assert rank.shape == key.shape
    for i in range(key.shape[0]):
        want_rank, want_sym = _scalar_join(tbl, int(key[i]), int(payload[i]), sigma, decode,
                                           seg_base, RAGGED_SEG_SHIFT)
        assert int(rank[i]) == want_rank, i
        if decode:
            assert int(sym[i]) == want_sym, i


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sigma,decode,segmented", RAGGED_MODES, ids=RAGGED_IDS)
@pytest.mark.parametrize("case", RAGGED_CASES)
def test_cuda_kernel_ragged_edges(cuda, case, sigma, decode, segmented, monkeypatch):
    monkeypatch.setattr(sj, "SEG_BLOCKS", 1 << RAGGED_SEG_SHIFT)
    tbl, key, payload, seg_base = _ragged_case(case, sigma, decode, segmented)
    tbl, key = torch.from_numpy(tbl).to(cuda), torch.from_numpy(key).to(cuda)
    payload = None if decode else torch.from_numpy(payload).to(cuda)
    seg_base = None if seg_base is None else torch.from_numpy(seg_base).to(cuda)
    rank, sym = sj.join(tbl, key, payload, sigma, decode, seg_base)
    rank_p, sym_p = sj.join_plain(tbl, key, payload, sigma, decode, seg_base, RAGGED_SEG_SHIFT)
    torch.cuda.synchronize()
    assert torch.equal(rank, rank_p)
    assert (sym is None and sym_p is None) or torch.equal(sym, sym_p)


@pytest.mark.cuda
@pytest.mark.parametrize("segmented", [False, True], ids=["plain", "seg"])
@pytest.mark.parametrize("sigma,decode", MODES)
def test_cuda_kernel_matches_plain(cuda, sigma, decode, segmented, monkeypatch):
    if segmented:
        monkeypatch.setattr(sj, "SEG_BLOCKS", 1 << 12)  # 13 segments of 4096 rows
    shift = sj._seg_shift() if segmented else None
    tbl, key, payload, seg_base = _random_case(sigma, 50_000, 1 << 20, 10 + sigma + decode,
                                               shift)
    tbl, key = torch.from_numpy(tbl).to(cuda), torch.from_numpy(key).to(cuda)
    payload = None if decode else torch.from_numpy(payload).to(cuda)
    seg_base = None if seg_base is None else torch.from_numpy(seg_base).to(cuda)
    mode = ("decode" if decode else "rank") + ("_seg" if segmented else "")
    before = sj.LAUNCHES[mode]
    rank, sym = sj.join(tbl, key, payload, sigma, decode, seg_base)
    rank_p, sym_p = sj.join_plain(tbl, key, payload, sigma, decode, seg_base, shift)
    torch.cuda.synchronize()
    assert sj.LAUNCHES[mode] == before + 1
    assert torch.equal(rank, rank_p)
    assert (sym is None and sym_p is None) or torch.equal(sym, sym_p)
    with pytest.raises(ValueError):  # wrong dtypes: no launch
        sj.join(tbl.to(torch.int64), key, payload, sigma, decode, seg_base)
    if segmented:
        with pytest.raises(ValueError):
            sj.join(tbl, key, payload, sigma, decode, seg_base[:1])  # too few segments
    assert sj.LAUNCHES[mode] == before + 1


@pytest.mark.cuda
def test_slice_on_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(6)
    n = 30_011
    text = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n))
    enc = ft.EncodingTable.from_symbols([b"A", b"C", b"G", b"T"])
    b = ft.FmIndexBuilder(n, 4, enc, position="u32", block=ft.BLOCK3_U64,
                          suffix_array_config=ft.SuffixArrayConfig.compressed(2),
                          lookup_table_config=ft.LookupTableConfig.kmer_size(3),
                          sa_backend="numpy")
    fm = ft.FmIndex.load(np.frombuffer(b.build(text), np.uint8), position="u32",
                         block=ft.BLOCK3_U64)
    kw = dict(sa_full="device", dense_lut_entries=4 ** 8, dense_host_entries=4 ** 6)
    cpu_dev = ft.to_device_torch(fm, "cpu", **kw)
    sj.LAUNCHES.clear()
    gpu_dev = ft.to_device_torch(fm, cuda, **kw)
    assert sj.LAUNCHES["decode"] > 0  # the SA fill decoded through the kernel
    for name in ("fused", "stream_tbl", "pair_tbl", "sa", "dense_lo", "dense_hi", "pair_c2",
                 "pair_fix"):
        assert torch.equal(getattr(gpu_dev, name).cpu(), getattr(cpu_dev, name)), name
    for plen in (15, 16, 9):
        starts = rng.integers(0, n - plen, size=3000)
        batch = np.frombuffer(text, np.uint8)[starts[:, None] + np.arange(plen)]
        for use_stream in (True, False):
            got = gpu_dev.locate_with_counts(batch, use_stream=use_stream)
            want = cpu_dev.locate_with_counts(batch, use_stream=use_stream)
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w)
    assert sj.LAUNCHES["rank"] > 0


@pytest.mark.cuda
def test_wide_slice_on_cuda_matches_cpu(cuda):
    """The wide engine on the card (segmented modes, 64-block segments so
    the 30 kbp text spans several) against the same upload on the CPU."""
    rng = np.random.default_rng(8)
    n = 30_011
    text = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n))
    enc = ft.EncodingTable.from_symbols([b"A", b"C", b"G", b"T"])
    b = ft.FmIndexBuilder(n, 4, enc, position="u64", block=ft.BLOCK3_U64,
                          suffix_array_config=ft.SuffixArrayConfig.compressed(3),
                          lookup_table_config=ft.LookupTableConfig.kmer_size(3),
                          sa_backend="numpy")
    fm = ft.FmIndex.load(np.frombuffer(b.build(text), np.uint8), position="u64",
                         block=ft.BLOCK3_U64)
    old = sj.SEG_BLOCKS
    sj.SEG_BLOCKS = 64
    try:
        cpu_dev = ft.to_device_torch(fm, "cpu", force_wide=True)
        gpu_dev = ft.to_device_torch(fm, cuda, force_wide=True)
        for name in ("fused", "stream_tbl", "seg_base", "sa", "dense_lo", "dense_hi"):
            assert torch.equal(getattr(gpu_dev, name).cpu(), getattr(cpu_dev, name)), name
        sj.LAUNCHES.clear()
        for plen in (15, 9):
            starts = rng.integers(0, n - plen, size=3000)
            batch = np.frombuffer(text, np.uint8)[starts[:, None] + np.arange(plen)]
            for use_stream in (True, False):
                got = gpu_dev.locate_with_counts(batch, use_stream=use_stream)
                want = cpu_dev.locate_with_counts(batch, use_stream=use_stream)
                for g, w in zip(got, want):
                    assert torch.equal(g.cpu(), w)
        assert sj.LAUNCHES["rank_seg"] > 0 and sj.LAUNCHES["decode_seg"] > 0
        assert sj.LAUNCHES["rank"] == sj.LAUNCHES["decode"] == 0
    finally:
        sj.SEG_BLOCKS = old
