"""The port's locate on a sampled suffix array, every row resolved by the LF
walk (``ops/locate.lf_walk``), held to the benchmark's plain reference
(``fmbench/reference.py``: sorted suffix keys, plain PyTorch, nothing of the
program), and the walk's counters held to a walk made in numpy.

Seeded random DNA texts of 20,000, 40,000 and 60,000 symbols are indexed as
the benchmark's ``dna20-1e8-sa32`` deployment is (u32, Block3<u64>, k=3,
the dna20 upload's dense seed, no full SA), at SA sampling r = 2, 32 and 64.
Each batch mixes 20-bp windows, 3-4 bp patterns that occur tens to
hundreds of times, and windows at the start of the text, whose rows' walks
meet the sentinel before a sampled row.  The pair-stream engine (its walk decoding
through the join) and the gather engine (decoding by gathers) must give
every count and every pattern's multiset of positions that the reference
gives.  Under a profiler, ``walk_row_steps`` must equal the steps a numpy
walk over the text's full suffix array counts (for each located row, the
rows it visits that are not multiples of r, up to and including the
sentinel's), ``walk_steps`` the longest such walk, ``walk_lanes`` a full
row buffer a step, and ``syncs`` ``walk_steps`` + 2.
"""
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import sview_fmindex_tpu_torch as ft  # noqa: E402
from fmbench import reference  # noqa: E402
from sview_fmindex_tpu_torch import tracing  # noqa: E402
from sview_fmindex_tpu_torch.utils.patterns import pack_patterns  # noqa: E402

ENCODING = {"symbols": ["A", "C", "G", "T"], "wildcard": False}
# the dna20 upload (fmbench/configs/dna20-1e8-sa32.json) without a full SA
UPLOAD = dict(dense_lut_entries=1 << 28, dense_host_entries=1 << 20)
L = 20
# SA sampling ratio: text length
TEXTS = {2: 20_000, 32: 40_000, 64: 60_000}
ENGINES = {"pair-stream": True, "gather": False}
_cache = {}


def suffix_array(text: np.ndarray) -> np.ndarray:
    """The text's suffix array by prefix doubling in numpy: a suffix that
    ends sorts before every longer one that it prefixes."""
    n = text.shape[0]
    rank = text.astype(np.int64) + 1
    k = 1
    while True:
        second = np.zeros(n, np.int64)
        second[:n - k] = rank[k:]
        order = np.lexsort((second, rank))
        r1, r2 = rank[order], second[order]
        new = np.empty(n, np.int64)
        new[order] = np.concatenate([[1], 1 + np.cumsum((r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1]))])
        rank = new
        if rank.max() == n:
            return order
        k *= 2


def setup_of(r):
    """(text, full SA, its inverse, the index on the CPU) for ratio ``r``."""
    if r not in _cache:
        n = TEXTS[r]
        rng = np.random.default_rng(np.random.SeedSequence(20261018, spawn_key=(r,)))
        text = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=n)]
        enc = ft.EncodingTable.from_symbols([b"A", b"C", b"G", b"T"])
        b = ft.FmIndexBuilder(
            n, enc.symbol_count(), enc, position="u32", block=ft.BLOCK3_U64,
            suffix_array_config=ft.SuffixArrayConfig.compressed(r),
            lookup_table_config=ft.LookupTableConfig.kmer_size(3), sa_backend="numpy")
        fm = ft.FmIndex.load(np.frombuffer(b.build(text.tobytes()), np.uint8),
                             position="u32", block=ft.BLOCK3_U64)
        sa = suffix_array(text)
        isa = np.empty_like(sa)
        isa[sa] = np.arange(n)
        dev = ft.to_device_torch(fm, "cpu", **UPLOAD)
        _cache[r] = (text, sa, isa, fm, dev)
    return _cache[r]


def batch(r):
    """(patterns [B, 20] uint8, lens int32 on the host): 1500 distinct
    20-bp windows, 200 patterns of 3-4 bp, and the 20-bp windows at the
    first 64 positions of the text."""
    text = setup_of(r)[0]
    rng = np.random.default_rng(r)
    starts = rng.choice(len(text) - L + 1, size=1500, replace=False)
    pats = [text[s:s + L] for s in starts]
    short = rng.integers(0, len(text) - 4, size=200)
    pats += [text[s:s + int(m)] for s, m in zip(short, rng.integers(3, 5, size=200))]
    pats += [text[s:s + L] for s in range(64)]
    packed, lens = pack_patterns(pats)
    return torch.from_numpy(packed), lens


def reference_answer(r):
    text = setup_of(r)[0]
    pats, lens = batch(r)
    ref = reference.ExactIndex(torch.from_numpy(text), ENCODING, L, torch.device("cpu"))
    return ref.answer(pats, torch.from_numpy(lens))


def positions(pid, pos):
    return sorted(zip(pid.tolist(), pos.tolist()))


def numpy_walk(sa, isa, r, rows):
    """Each row's LF steps: the rows its walk decodes, those that are not
    multiples of ``r``, up to and including the sentinel's (the row of
    suffix 0); and how many walks met the sentinel."""
    p = sa[rows].astype(np.int64)
    live = rows % r != 0
    steps = np.zeros(rows.shape[0], np.int64)
    sentinel = 0
    while live.any():
        steps += live
        hit = live & (p == 0)
        sentinel += int(hit.sum())
        live &= ~hit
        p = np.where(live, p - 1, p)
        live &= isa[p] % r != 0
    return steps, sentinel


@pytest.mark.parametrize("r", sorted(TEXTS))
def test_the_numpy_sa_is_the_index_s(r):
    """The walk made in numpy reads rows as the index numbers them: every
    r-th entry of the full SA is the index's sampled SA."""
    _, sa, _, fm, dev = setup_of(r)
    assert fm.sampling_ratio == r and not dev.meta.has_sa_full
    assert np.array_equal(sa[::r], np.asarray(fm.suffix_array).astype(np.int64))


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("r", sorted(TEXTS))
def test_walk_locate_equals_reference(r, engine):
    _, _, _, _, dev = setup_of(r)
    pats, lens = batch(r)
    ref_counts, ref_pid, ref_pos = reference_answer(r)
    assert dev.engine_for(pats.shape[0], ENGINES[engine]) == engine
    locs, pids, valid, counts, dropped = dev.locate_with_counts(
        pats, lens, use_stream=ENGINES[engine])
    assert int(dropped.sum()) == 0
    assert torch.equal(counts, ref_counts)
    # the short patterns occur tens to hundreds of times
    assert int(ref_counts[1500:1700].min()) > 20
    assert positions(pids[valid], locs[valid]) == positions(ref_pid, ref_pos)


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("r", sorted(TEXTS))
def test_walk_counters_equal_a_numpy_walk(r, engine):
    _, sa, isa, _, dev = setup_of(r)
    pats, lens = batch(r)
    _, _, ref_pos = reference_answer(r)
    steps, sentinel = numpy_walk(sa, isa, r, isa[ref_pos.numpy()])
    if r > 2:
        # some walks from the text's start meet the sentinel first
        assert sentinel > 0
    tracing.COUNTS.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        dev.locate_with_counts(pats, lens, use_stream=ENGINES[engine])
    got = dict(tracing.COUNTS)
    assert got["walk_row_steps"] == int(steps.sum())
    assert got["walk_steps"] == int(steps.max())
    assert got["walk_lanes"] == got["walk_steps"] * got["slots"]
    # the capacity read, a test a step, and the last test, which finds none
    assert got["syncs"] == got["walk_steps"] + 2


def test_walk_span_holds_the_walk_inside_resolve(tmp_path):
    _, _, _, _, dev = setup_of(32)
    pats, lens = batch(32)
    path = tmp_path / "trace.json"
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        dev.locate_with_counts(pats, lens, use_stream=True)
    prof.export_chrome_trace(str(path))
    events = json.load(open(path))["traceEvents"]

    def span(name):
        (a, d), = [(float(e["ts"]), float(e["dur"])) for e in events
                   if e.get("cat") == "user_annotation" and e["name"] == name]
        return a, a + d

    resolve, walk = span("fmindex.resolve"), span("fmindex.walk")
    assert resolve[0] <= walk[0] <= walk[1] <= resolve[1]
    # every decode of the walk, one sort a step, starts inside the span
    sorts = [float(e["ts"]) for e in events
             if e.get("cat") == "cpu_op" and e["name"] == "aten::sort"
             and resolve[0] <= float(e["ts"]) <= resolve[1]]
    assert sorts and all(walk[0] <= t <= walk[1] for t in sorts)
