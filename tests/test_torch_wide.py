"""Port parity: the wide (u64-position) engine (sview_fmindex_tpu_torch/ops/wide.py
and the wide upload of models/device_index.py).

``force_wide=True`` runs the exact wide code path on small texts, as
``tests/test_wide.py`` does for the JAX package.  The same seeded texts and
batches go through the port (stream and gather engines), the JAX wide engine
(gather on every case; its stream engine, Pallas in interpret mode, on one)
and the host oracle: u32 and u64 blobs, sampling ratios 2 and 3, mixed
lengths (the per-step body) and uniform lengths (the sorted sigma chain),
patterns shorter than k, and wildcard bytes.  The same answers must come
back with the stream table cut into 4-block segments, and from the JAX
index's state.  Counts and located positions must be exactly equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import sview_fmindex_tpu as fmx  # noqa: E402
from sview_fmindex_tpu.models.device_index import DeviceFmIndex as JaxDeviceFmIndex  # noqa: E402
from sview_fmindex_tpu.ops.wide import combine64  # noqa: E402
from sview_fmindex_tpu.utils.patterns import pack_patterns  # noqa: E402
from sview_fmindex_tpu_torch import DeviceFmIndex, to_device_torch  # noqa: E402
from sview_fmindex_tpu_torch.ops import stream_join as tsj  # noqa: E402

CASES = [(3001, "u32", 2), (917, "u64", 2), (64, "u64", 2), (917, "u64", 3)]
IDS = [f"{n}-{p}-r{r}" for n, p, r in CASES]
_cache = {}


def _build(n, pos_t, r, seed):
    rng = np.random.default_rng(seed)
    text = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n))
    # lower-case bytes map to their symbols; every other byte is the wildcard
    enc = fmx.EncodingTable.from_symbols([b"Aa", b"Cc", b"Gg", b"Tt"])
    b = fmx.FmIndexBuilder(
        n, 4, enc, position=pos_t, block=fmx.BLOCK3_U64,
        suffix_array_config=fmx.SuffixArrayConfig.compressed(r),
        lookup_table_config=fmx.LookupTableConfig.kmer_size(3), sa_backend="numpy")
    return text, fmx.FmIndex.load(np.frombuffer(b.build(text), np.uint8),
                                  position=pos_t, block=fmx.BLOCK3_U64)


def _index(case):
    if case not in _cache:
        n, pos_t, r = case
        text, fm = _build(n, pos_t, r, seed=n + r)
        jdev = JaxDeviceFmIndex.from_host(fm, force_wide=True)
        tdev = to_device_torch(fm, "cpu", force_wide=True)
        _cache[case] = dict(text=text, fm=fm, jdev=jdev, tdev=tdev)
    return _cache[case]


def _batch(text, kind, seed):
    rng = np.random.default_rng(seed)
    plen = min(12, len(text) // 2)
    starts = rng.integers(0, len(text) - plen, size=40)
    if kind == "uniform":
        pats = [text[s:s + plen] for s in starts]
        pats[3] = b"T" * plen  # likely absent: an empty range rides the chain
    else:
        lens = rng.integers(1, plen + 1, size=40)
        pats = [text[s:s + m] for s, m in zip(starts, lens)]
        # shorter than k=3, and wildcard bytes (== the last symbol)
        pats += [b"A", b"cg", b"T", b"GA", b"ACGTN", b"xx", b"aNNt"]
    return pats, *pack_patterns(pats)


def _by_pattern(locs, pids, valid):
    by = {}
    for loc, p in zip(locs[valid].tolist(), pids[valid].tolist()):
        by.setdefault(p, []).append(loc)
    return {p: sorted(v) for p, v in by.items()}


def _check(fm, tdev, pats, batch, lens, use_stream, jdev=None):
    """The port's counts and locations against the oracle, and against
    ``jdev`` (a JAX wide index) on the same engine when given."""
    c = tdev.count(batch, lens, use_stream=use_stream)
    assert c.dtype == torch.int64 and c.shape == (len(pats),)
    np.testing.assert_array_equal(c.numpy(), [fm.count(p) for p in pats])
    locs, pids, valid, counts, dropped = tdev.locate_with_counts(
        batch, lens, use_stream=use_stream)
    assert int(dropped[0]) == 0 and torch.equal(counts, c)
    by = _by_pattern(locs, pids, valid)
    for i, p in enumerate(pats):
        assert by.get(i, []) == sorted(fm.locate(p)), i
    if jdev is not None:
        np.testing.assert_array_equal(
            c.numpy(), combine64(*np.asarray(jdev.count(batch, lens, use_stream=use_stream))))
        jl, jp, jv, jd = (np.asarray(a) for a in jdev.locate(
            batch, lens, capacity=locs.shape[0], use_stream=use_stream))
        assert int(jd[0]) == 0
        np.testing.assert_array_equal(valid.numpy(), jv)
        np.testing.assert_array_equal(locs.numpy()[jv], combine64(jl[0], jl[1])[jv].astype(np.int64))
        np.testing.assert_array_equal(pids.numpy()[jv], jp[jv])
    return c, by


@pytest.mark.parametrize("kind", ["mixed", "uniform"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_wide_engines_match_reference_and_oracle(case, kind):
    ix = _index(case)
    fm, tdev, jdev = ix["fm"], ix["tdev"], ix["jdev"]
    assert tdev.meta.wide_pos and tdev.meta.dense_k == jdev.meta.dense_k > 0
    assert tdev.engine_for(64) == "wide-stream"
    assert tdev.engine_for(64, use_stream=False) == "wide-gather"
    pats, batch, lens = _batch(ix["text"], kind, seed=case[0] + len(kind))
    stream = _check(fm, tdev, pats, batch, lens, True)
    gather = _check(fm, tdev, pats, batch, lens, False, jdev)
    assert torch.equal(stream[0], gather[0]) and stream[1] == gather[1]


def test_wide_stream_engine_matches_reference_stream_engine():
    """The JAX wide stream engine (blkkey kernel, interpret mode) on one
    mixed batch: same counts and same locations slot for slot."""
    ix = _index(CASES[0])
    pats, batch, lens = _batch(ix["text"], "mixed", seed=5)
    _check(ix["fm"], ix["tdev"], pats, batch, lens, True, ix["jdev"])


def test_sentinel_row_on_a_u64_blob():
    """The sentinel shift and the sentinel-row test at the row itself: a
    pattern ending the text sits at the sentinel row's LF predecessor, and
    the walk resolves it through the short-circuit."""
    ix = _index(CASES[1])
    fm, tdev, text = ix["fm"], ix["tdev"], ix["text"]
    pats = [text[-m:] for m in (1, 2, 5, 9, 12)] + [text[:7], text[:12]]
    batch, lens = pack_patterns(pats)
    for use_stream in (True, False):
        _check(fm, tdev, pats, batch, lens, use_stream)


def test_small_segments_give_the_same_answers(monkeypatch):
    """4-block segments: a 4 kbp text spans 8 of them.  The local table
    plus its bases must rebuild the global checkpoints, and every answer
    must stay the same."""
    text, fm = _build(4000, "u64", 2, seed=31)
    batches = [_batch(text, kind, seed=9) for kind in ("mixed", "uniform")]
    whole = to_device_torch(fm, "cpu", force_wide=True)
    want = [_check(fm, whole, *b, use_stream) for b in batches for use_stream in (True, False)]
    monkeypatch.setattr(tsj, "SEG_BLOCKS", 4)
    seg = to_device_torch(fm, "cpu", force_wide=True)
    assert whole.seg_base.shape == (1, 4) and seg.seg_base.shape == (8, 4)
    assert torch.equal(seg.stream_tbl[:, 4:], whole.stream_tbl[:, 4:])
    rows = torch.arange(seg.stream_tbl.shape[0])
    glob = seg.stream_tbl[:, :4].long() + seg.seg_base[rows // 4]
    assert torch.equal(glob, whole.stream_tbl[:, :4].long() + whole.seg_base[0])
    got = [_check(fm, seg, *b, use_stream) for b in batches for use_stream in (True, False)]
    for g, w in zip(got, want):
        assert torch.equal(g[0], w[0]) and g[1] == w[1]


def test_wide_state_from_reference():
    """The port answers from the JAX wide index's state as from its own."""
    ix = _index(CASES[1])
    fm, tdev, jdev = ix["fm"], ix["tdev"], ix["jdev"]
    arrays = {f.name: np.asarray(getattr(jdev, f.name))
              for f in dataclasses.fields(jdev) if f.name != "meta"}
    rdev = DeviceFmIndex.from_reference(arrays, jdev.meta, device="cpu")
    for name in ("fused", "stream_tbl", "seg_base", "sa", "dense_lo", "dense_hi",
                 "count_arr", "kmer_tbl", "enc_table"):
        assert torch.equal(getattr(rdev, name), getattr(tdev, name)), name
    assert rdev.meta == tdev.meta and rdev.sentinel == tdev.sentinel
    assert rdev.pair_tbl is None and rdev.pair_c2 is None
    for kind in ("mixed", "uniform"):
        pats, batch, lens = _batch(ix["text"], kind, seed=17)
        _check(fm, rdev, pats, batch, lens, True)


def test_wide_upload_options():
    """No stream table without ``stream`` (the gather engine serves every
    batch); ``dense_lut_entries=0`` turns the host dense seeds off."""
    ix = _index(CASES[0])
    fm = ix["fm"]
    bare = to_device_torch(fm, "cpu", force_wide=True, stream=False, dense_lut_entries=0)
    assert bare.meta.wide_pos and bare.meta.stream_rows == 0 and bare.meta.dense_k == 0
    assert bare.stream_tbl is None and bare.seg_base is None
    assert bare.engine_for(1 << 20, use_stream=True) == "wide-gather"
    for kind in ("mixed", "uniform"):
        pats, batch, lens = _batch(ix["text"], kind, seed=23)
        _check(fm, bare, pats, batch, lens, None)
