"""The gather engine's CUDA kernel (sview_fmindex_tpu_torch/csrc/gather_search.cu)
against its plain version, ``ops/search.gather_ranges``.

On a card (``@pytest.mark.cuda``; skipped without one) the kernel's ``lo,
hi`` must equal the per-step PyTorch loop on the same device exactly: at
sigma 4 (2 planes, and blocks of 32, 64 and 128 positions), 5 (3 planes,
wildcard DNA), 20 (5) and 63 (6); with no dense seed and with one; uniform
lengths at or above ``dense_k``, and mixed lengths 0-30 (some under the
k-mer size, some on both sides of ``dense_k``) holding bytes outside the
alphabet; B of 0, 1, 4096 and 32767; and on a synthetic fused table of
2^26 + 1 rows whose positions and checkpoint words lie past 2^31.

On the CPU: ``pos_ranges`` never calls the kernel's wrapper, its gather
engine answers as before, the wrapper refuses a batch the kernel does not take
before it loads a library, ``check_gather_tables`` refuses the tables it
does not take, and ``gather_kernel`` is counted at the launch, only while a
profiler records.  This file imports no JAX, so on a machine without it the
card tests run with
``python -m pytest tests/test_torch_gather_search.py -m cuda --noconftest``.
"""
import contextlib
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import sview_fmindex_tpu_torch as ft  # noqa: E402
from sview_fmindex_tpu_torch import kernels, tracing  # noqa: E402
from sview_fmindex_tpu_torch.models.device_index import _as_batch  # noqa: E402
from sview_fmindex_tpu_torch.ops import search  # noqa: E402
from sview_fmindex_tpu_torch.ops.rank import rank_next, to_i32  # noqa: E402

TEXT_LEN = 65011
DENSE_ENTRIES = 1 << 18  # dense_k 8 at sigma 4, 7 at 5, 4 at 20, 3 at 63
# name: (alphabet, block, kmer size)
CONFIGS = {
    "dna4": (b"ACGT", ft.BLOCK3_U64, 3),
    "dna4_u32": (b"ACGT", ft.BLOCK2_U32, 3),
    "dna4_u128": (b"ACGT", ft.BLOCK3_U128, 3),
    "wild5": ("wild", ft.BLOCK3_U64, 3),
    "prot20": (b"ACDEFGHIKLMNPQRSTVWY", ft.BLOCK5_U64, 2),
    "sym63": (bytes(range(33, 96)), ft.BLOCK6_U64, 2),
}


def build_index(name: str, seed: int = 7):
    """(host FmIndex, text) of a seeded text of TEXT_LEN symbols."""
    alphabet, block, k = CONFIGS[name]
    rng = np.random.default_rng(seed)
    if alphabet == "wild":
        enc = ft.EncodingTable.from_symbols_with_wildcard([b"A", b"C", b"G", b"T"])
        # one byte in 50 is N, the wildcard
        text = rng.choice(np.frombuffer(b"ACGT" * 12 + b"NN", np.uint8), size=TEXT_LEN)
    else:
        enc = ft.EncodingTable.from_symbols([bytes([c]) for c in alphabet])
        text = rng.choice(np.frombuffer(alphabet, np.uint8), size=TEXT_LEN)
    b = ft.FmIndexBuilder(
        TEXT_LEN, enc.symbol_count(), enc, position="u32", block=block,
        suffix_array_config=ft.SuffixArrayConfig.compressed(2),
        lookup_table_config=ft.LookupTableConfig.kmer_size(k), sa_backend="numpy")
    fm = ft.FmIndex.load(np.frombuffer(b.build(text.tobytes()), np.uint8), position="u32",
                         block=block)
    return fm, text


def batch(text: np.ndarray, B: int, lens, seed: int, foreign: bool = False):
    """B patterns cut from the text, padded to the longest of ``lens``
    (a length or a per-lane array) with bytes outside every alphabet;
    ``foreign``: one byte in 8 of each pattern replaced by such a byte."""
    rng = np.random.default_rng(seed)
    lens = np.broadcast_to(np.asarray(lens, np.int64), (B,)).copy()
    L = max(int(lens.max()) if B else 1, 1)
    starts = rng.integers(0, text.shape[0] - L, size=B)
    pats = text[starts[:, None] + np.arange(L)].copy()
    if foreign:
        pats[rng.random(pats.shape) < 1 / 8] = ord("x")
    pats[np.arange(L)[None, :] >= lens[:, None]] = ord("~")
    return pats, lens


def searched(dev, pats, lens):
    """The encoded batch on ``dev``'s device and its host facts."""
    p, l, steps, (all_dense, fixed_len) = _as_batch(dev.meta, pats, lens, dev.device)
    return search.encode_patterns(dev.enc_table, p), l, steps, all_dense, fixed_len


# ----------------------------------------------------------------------
# on the CPU
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_index():
    fm, text = build_index("dna4")
    return ft.to_device_torch(fm, "cpu", dense_lut_entries=DENSE_ENTRIES), fm, text


def _spy(monkeypatch, module, name):
    """Record each call of ``module.name``."""
    fn = getattr(module, name)
    seen = []

    def wrapper(*args, **kwargs):
        seen.append(args)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapper)
    return seen


@pytest.mark.parametrize("lens", [20, "mixed"], ids=["uniform20", "mixed0-30"])
def test_cpu_gather_engine_never_calls_the_kernel(cpu_index, monkeypatch, lens):
    """On the CPU the gather engine is the per-step loop: ``pos_ranges``
    never reaches the kernel's wrapper, and its ranges are the plain
    version's, and the host index's counts."""
    dev, fm, text = cpu_index
    lens = np.random.default_rng(3).integers(0, 31, size=300) if lens == "mixed" else lens
    pats, lens = batch(text, 300, lens, seed=4)
    calls = _spy(monkeypatch, search, "gather_ranges_cuda")
    sym, l, steps, all_dense, fixed_len = searched(dev, pats, lens)
    lo, hi = search.pos_ranges(dev, sym, l, steps, use_stream=False,
                               all_dense=all_dense, fixed_len=fixed_len)
    plo, phi = search.gather_ranges(dev, sym, l, steps, all_dense, fixed_len)
    assert calls == []
    assert torch.equal(lo, plo) and torch.equal(hi, phi)
    want = [fm.count(bytes(p[:n])) for p, n in zip(pats, lens)]
    assert (hi - lo).tolist() == want
    counts = dev.count(pats, lens, use_stream=False)
    assert calls == [] and counts.tolist() == want


@pytest.mark.parametrize("plen", [2, 5, 8, 11, 20], ids=lambda n: f"len{n}")
def test_gather_ranges_is_the_per_step_loop(cpu_index, plen):
    """The plain version unrolled by hand: seed, then single-symbol LF
    steps over ``ops.rank.rank_next`` while a lane's range is not empty;
    both sides of dense_k (8) and of the k-mer size (3)."""
    dev, _, text = cpu_index
    pats, lens = batch(text, 64, plen, seed=plen)
    sym, l, steps, all_dense, fixed_len = searched(dev, pats, lens)
    lo, hi, rem, seed_len = search.initial_range(dev.meta, dev.kmer_tbl, dev.dense_lo,
                                                 dev.dense_hi, sym, l)
    lo, hi, rem, seed_len = (x.tolist() for x in (lo, hi, rem, seed_len))
    for b in range(64):
        for t in range(min(rem[b], steps)):
            if not lo[b] < hi[b]:
                break
            c = int(sym[b, int(l[b]) - seed_len[b] - 1 - t])
            ends = torch.tensor([lo[b], hi[b]])
            r = rank_next(dev.meta, dev.fused, dev.sentinel, ends, torch.tensor([c, c]))
            lo[b], hi[b] = (int(dev.count_arr[c]) + r).tolist()
    got = search.gather_ranges(dev, sym, l, steps, all_dense, fixed_len)
    assert got[0].tolist() == lo and got[1].tolist() == hi


def _no_library(monkeypatch):
    """Make loading the kernel's library fail the test."""
    def refuse():
        raise AssertionError("the wrapper loaded the kernel's library")

    monkeypatch.setattr(kernels, "gather_search_lib", refuse)


def test_wrapper_refuses_a_cpu_tensor(cpu_index, monkeypatch):
    dev, _, text = cpu_index
    _no_library(monkeypatch)
    sym, l, steps, _, _ = searched(dev, *batch(text, 8, 20, seed=1))
    with pytest.raises(ValueError, match="CUDA device"):
        search.gather_ranges_cuda(dev, sym, l, steps)


def _fake_cuda(monkeypatch):
    """``Tensor.is_cuda`` reads True, so the checks past the device's are
    reached on the CPU (``is_cuda`` is a property of the tensor's class)."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))


BATCH_FAULTS = {"sym_int32": "sym must", "sym_1d": "sym must",
                "sym_noncontiguous": "not contiguous", "lens_int32": "lens must",
                "lens_short": "lens must"}


@pytest.mark.parametrize("fault", list(BATCH_FAULTS))
def test_wrapper_refuses_before_it_loads_a_library(cpu_index, monkeypatch, fault):
    """A wrong dtype, shape or layout of the batch is refused with a
    ValueError, and no library is loaded."""
    dev, _, text = cpu_index
    sym, l, steps, _, _ = searched(dev, *batch(text, 8, 20, seed=2))
    if fault == "sym_int32":
        sym = sym.int()
    elif fault == "sym_1d":
        sym = sym.reshape(-1)
    elif fault == "sym_noncontiguous":
        sym = torch.cat([sym, sym], 1)[:, ::2]
        assert not sym.is_contiguous()
    elif fault == "lens_int32":
        l = l.int()
    else:
        l = l[:-1]
    _no_library(monkeypatch)
    _fake_cuda(monkeypatch)
    with pytest.raises(ValueError, match=BATCH_FAULTS[fault]):
        search.gather_ranges_cuda(dev, sym, l, steps)


TABLE_FAULTS = {"none": None, "fused_int64": "fused must", "fused_width": "fused must",
                "fused_noncontiguous": "fused must", "kmer_int32": "kmer_tbl must",
                "dense_lo_missing": "dense_lo must", "wide": "narrow indexes",
                "planes_7": "narrow indexes"}


@pytest.mark.parametrize("fault", list(TABLE_FAULTS))
def test_tables_the_kernel_takes(cpu_index, fault):
    """``check_gather_tables`` (run once by a card upload): an index as
    ``from_host`` builds it passes; a table of another dtype, width or
    layout, a missing dense table, a wide index or one of 7 planes is
    refused with a ValueError."""
    dev, _, _ = cpu_index
    assert dev.meta.dense_k
    meta = dev.meta
    change = {
        "none": {},
        "fused_int64": dict(fused=dev.fused.long()),
        "fused_width": dict(fused=dev.fused[:, :-1].contiguous()),
        "fused_noncontiguous": dict(fused=dev.fused.t().contiguous().t()),
        "kmer_int32": dict(kmer_tbl=dev.kmer_tbl.int()),
        "dense_lo_missing": dict(dense_lo=None),
        "wide": dict(meta=dataclasses.replace(meta, wide_pos=True)),
        "planes_7": dict(meta=dataclasses.replace(meta, num_planes=7)),
    }[fault]
    bad = dataclasses.replace(dev, **change)
    if TABLE_FAULTS[fault] is None:
        search.check_gather_tables(bad)
    else:
        with pytest.raises(ValueError, match=TABLE_FAULTS[fault]):
            search.check_gather_tables(bad)


class _FakeLib:
    """The kernel's library as ctypes shows it, launching nothing: returns
    ``err`` for each call."""

    def __init__(self, err: int = 0):
        self.err, self.calls = err, 0

    def sview_gather_search(self, *args):
        self.calls += 1
        return self.err


def _fake_launch(monkeypatch, err: int = 0) -> _FakeLib:
    """The wrapper's launch reached on the CPU: a library that launches
    nothing, and the CUDA device and stream it asks for."""
    lib = _FakeLib(err)
    monkeypatch.setattr(kernels, "gather_search_lib", lambda: lib)
    monkeypatch.setattr(kernels, "cuda_error", lambda e: f"CUDA error {e}")
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    _fake_cuda(monkeypatch)
    return lib


def test_gather_kernel_counted_at_the_launch_only_while_a_profiler_records(cpu_index,
                                                                          monkeypatch):
    """``gather_kernel`` is counted where the kernel launches, beside
    ``LAUNCHES["gather"]``: never for the CPU's gather engine or the stream
    engine, never outside a profiler, once a launch inside one, and not for
    a launch that failed."""
    from torch.profiler import ProfilerActivity, profile

    dev, _, text = cpu_index
    pats, lens = batch(text, 16, 20, seed=5)
    monkeypatch.setattr(tracing, "COUNTS", tracing.COUNTS.__class__())
    monkeypatch.setattr(search, "LAUNCHES", search.LAUNCHES.__class__())
    with profile(activities=[ProfilerActivity.CPU]):
        dev.count(pats, lens, use_stream=False)
        dev.count(pats, lens, use_stream=True)
    assert tracing.COUNTS["calls"] == 2 and "gather_kernel" not in tracing.COUNTS
    sym, l, steps, _, _ = searched(dev, pats, lens)
    lib = _fake_launch(monkeypatch)
    search.pos_ranges(dev, sym, l, steps)
    assert lib.calls == 1 and search.LAUNCHES["gather"] == 1
    assert "gather_kernel" not in tracing.COUNTS
    with profile(activities=[ProfilerActivity.CPU]):
        search.pos_ranges(dev, sym, l, steps)
        search.gather_ranges_cuda(dev, sym, l, steps)
    assert lib.calls == 3 and search.LAUNCHES["gather"] == 3
    assert tracing.COUNTS["gather_kernel"] == 2
    lib.err = 700
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            search.pos_ranges(dev, sym, l, steps)
    assert search.LAUNCHES["gather"] == 3 and tracing.COUNTS["gather_kernel"] == 2


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


_CARD = {}


def card_index(name: str, dense: bool):
    """The configuration uploaded to the card, dense seed or none (cached
    for the module)."""
    key = (name, dense)
    if key not in _CARD:
        fm, text = build_index(name)
        dev = ft.to_device_torch(fm, "cuda", dense_lut_entries=DENSE_ENTRIES if dense else 0)
        assert bool(dev.meta.dense_k) == dense
        _CARD[key] = dev, fm, text
    return _CARD[key]


def assert_kernel_is_plain(dev, pats, lens):
    """Kernel and plain version on the same device, exactly equal; returns
    the kernel's ranges."""
    sym, l, steps, all_dense, fixed_len = searched(dev, pats, lens)
    before = search.LAUNCHES["gather"]
    lo, hi = search.pos_ranges(dev, sym, l, steps, all_dense=all_dense, fixed_len=fixed_len)
    assert search.LAUNCHES["gather"] == before + (pats.shape[0] > 0)
    plo, phi = search.gather_ranges(dev, sym, l, steps, all_dense, fixed_len)
    torch.cuda.synchronize()
    assert lo.dtype == hi.dtype == torch.int64 and lo.shape == hi.shape == (pats.shape[0],)
    assert torch.equal(lo, plo) and torch.equal(hi, phi)
    return lo, hi


CARD_CASES = [(name, dense) for name in CONFIGS for dense in (False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,dense", CARD_CASES,
                         ids=[f"{n}-{'dense' if d else 'nodense'}" for n, d in CARD_CASES])
@pytest.mark.parametrize("lens", ["uniform", "mixed"])
def test_kernel_equals_the_loop(cuda, name, dense, lens):
    """Uniform lengths at or above dense_k (20), and mixed lengths 0-30
    with foreign bytes: exact, and the host index's counts."""
    dev, fm, text = card_index(name, dense)
    B = 4096
    if lens == "uniform":
        pats, plens = batch(text, B, max(20, dev.meta.dense_k), seed=11)
    else:
        pats, plens = batch(text, B, np.random.default_rng(12).integers(0, 31, size=B),
                            seed=13, foreign=True)
    lo, hi = assert_kernel_is_plain(dev, pats, plens)
    sample = np.random.default_rng(14).choice(B, size=64, replace=False)
    want = [fm.count(bytes(pats[b, :plens[b]])) for b in sample]
    assert (hi - lo).cpu()[torch.from_numpy(sample)].tolist() == want
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("B", [0, 1, 4096, 32767])
def test_kernel_batch_sizes(cuda, B):
    """B of 0, 1, 4096 and 32767 (off the block and warp size), mixed
    lengths straddling dense_k, through ``count`` as a caller sends them."""
    dev, fm, text = card_index("dna4", True)
    pats, plens = batch(text, B, np.random.default_rng(B).integers(1, 31, size=B), seed=B)
    assert_kernel_is_plain(dev, pats, plens)
    before = search.LAUNCHES["gather"]
    counts = dev.count(pats, plens, use_stream=False)
    assert search.LAUNCHES["gather"] == before + (B > 0)
    if B:
        assert counts[:1].tolist() == [fm.count(bytes(pats[0, :plens[0]]))]
    torch.cuda.synchronize()


HIGH_ROWS = (1 << 26) + 1  # blocks of 64 positions: every u32 position has a row


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True], ids=["nodense", "dense"])
def test_kernel_past_2_31(cuda, dense):
    """A synthetic fused table of 2^26 + 1 rows at dna4's layout (2 GB):
    random plane words, checkpoint words 2^31 + 24 b + c (negative as
    int32), seeds and the k-mer table in [2^31, 2^32), the sentinel past
    2^31: every position the search visits lies past 2^31.  Kernel and
    loop exactly equal; ranges past 2^31 seen."""
    dev, _, text = card_index("dna4", dense)
    g = torch.Generator(device=cuda).manual_seed(31)
    meta = dev.meta
    width = meta.sigma + meta.num_planes * meta.num_lanes
    fused = torch.randint(-2**31, 2**31, (HIGH_ROWS, width), generator=g,
                          device=cuda).to(torch.int32)
    rows = torch.arange(HIGH_ROWS, device=cuda)[:, None]
    fused[:, :meta.sigma] = to_i32(2**31 + 24 * rows + torch.arange(meta.sigma, device=cuda))
    kmer = torch.sort(torch.randint(2**31, 2**32 - 2**28, dev.kmer_tbl.shape, generator=g,
                                    device=cuda))[0]
    high = dict(fused=fused, kmer_tbl=kmer, sentinel=2**31 + 12345,
                count_arr=torch.arange(meta.sigma + 1, device=cuda) * 1000)
    if dense:
        lo = torch.randint(2**31, 2**32 - 2**28, dev.dense_lo.shape, generator=g, device=cuda)
        high.update(dense_lo=to_i32(lo), dense_hi=to_i32(lo + torch.randint(
            0, 2**20, lo.shape, generator=g, device=cuda)))
    hdev = dataclasses.replace(dev, **high)
    pats, plens = batch(text, 4096, np.random.default_rng(21).integers(1, 31, size=4096),
                        seed=22)
    lo, hi = assert_kernel_is_plain(hdev, pats, plens)
    assert int(lo.min()) >= 2**31 and int(hi.max()) < 2**32
    assert int((hi > lo).sum()) > 0
    del hdev, fused
    torch.cuda.synchronize()
