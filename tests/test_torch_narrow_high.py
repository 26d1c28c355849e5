"""Port parity at the values of a narrow (u32-position) index between 2^31 and
2^32 bp, where every table word past 2^31 reads negative as int32.

A CPU cannot hold such an index, so the tables of a small one are lifted:
2^31 + c is added to every checkpoint word (stream table, fused rows), SA
value, range end or dense seed, and the same numpy inputs go through the
port and the JAX package (Pallas in interpret mode, as its own tests run
it).  The lifted answers must equal each other and the unlifted answer
plus the lift; ``c`` is small or takes the largest rank to 2^32 - 1.  Also:
the word round trips at the edges, ``from_reference`` with a ``j_star`` of
2^31 and more, the SA fill's piecewise passes with the piece patched to 7,
the smoke run's opt-in size guard, and the one text generator that
``bench_torch.py`` and ``chip_smoke.py`` share.  Exact equality.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import sview_fmindex_tpu as fmx  # noqa: E402
from sview_fmindex_tpu.ops import locate as jlocate  # noqa: E402
from sview_fmindex_tpu.ops import rank as jrank  # noqa: E402
from sview_fmindex_tpu.ops import search as jsearch  # noqa: E402
from sview_fmindex_tpu.ops import stream_join as jsj  # noqa: E402
import sview_fmindex_tpu_torch as ft  # noqa: E402
from sview_fmindex_tpu_torch import DeviceFmIndex, to_device_torch  # noqa: E402
from sview_fmindex_tpu_torch.build import sa_fill  # noqa: E402
from sview_fmindex_tpu_torch.ops import locate as tlocate  # noqa: E402
from sview_fmindex_tpu_torch.ops import rank as trank  # noqa: E402
from sview_fmindex_tpu_torch.ops import search as tsearch  # noqa: E402
from sview_fmindex_tpu_torch.ops import stream_join as tsj  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench_torch  # noqa: E402
import chip_smoke  # noqa: E402

N = 6007
T = 256  # reference stream tile
HIGH = 2**31
# lifts: a small one, and the largest that keeps every rank below 2^32
LIFTS = {"low": HIGH + 12345, "top": 2**32 - 1 - N}
CORPUS = os.path.join(REPO, "interop", "corpus")


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(31)
    text = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=N))
    enc = fmx.EncodingTable.from_symbols([b"A", b"C", b"G", b"T"])
    b = fmx.FmIndexBuilder(
        N, 4, enc, position="u32", block=fmx.BLOCK3_U64,
        suffix_array_config=fmx.SuffixArrayConfig.compressed(2),
        lookup_table_config=fmx.LookupTableConfig.kmer_size(3), sa_backend="numpy")
    fm = fmx.FmIndex.load(np.frombuffer(b.build(text), np.uint8), position="u32",
                          block=fmx.BLOCK3_U64)
    jdev = fm.to_device(dense_lut_entries=0, stream_tile=T)
    tdev = to_device_torch(fm, "cpu", dense_lut_entries=0)
    return dict(text=text, fm=fm, jdev=jdev, tdev=tdev)


def _lift_u32(words: np.ndarray, lift: int) -> np.ndarray:
    """uint32 words + lift, no word past 2^32 - 1 (asserted)."""
    out = words.astype(np.int64) + lift
    assert out.max() < 2**32
    return out.astype(np.uint32)


# ----------------------------------------------------------------------
# the word codec
# ----------------------------------------------------------------------

def test_word_round_trips_at_the_edges():
    values = np.array([0, HIGH - 1, HIGH, 2**32 - 1], np.int64)
    words = trank.to_i32(torch.from_numpy(values))
    assert words.dtype == torch.int32
    # the bits are the uint32 values' (as the JAX package stores them)
    np.testing.assert_array_equal(words.numpy(), values.astype(np.uint32).view(np.int32))
    assert words.tolist() == [0, HIGH - 1, -HIGH, -1]
    np.testing.assert_array_equal(trank.u32(words).numpy(), values)
    np.testing.assert_array_equal(
        trank.u32(torch.from_numpy(values.astype(np.uint32).view(np.int32))).numpy(), values)
    # int64 tensors are values already: u32 leaves them as they are
    np.testing.assert_array_equal(trank.u32(torch.from_numpy(values)).numpy(), values)


# ----------------------------------------------------------------------
# the join: its plain version and the sorted entry points
# ----------------------------------------------------------------------

def _stream_tables(index, sigma: int, lift: int):
    """The JAX layout table of ``sigma`` (sigma 4: the index's BWT; sigma
    16: a seeded code sequence of the same length) built by the JAX
    package, its lifted copy, and both converted by the port's adapter."""
    fm = index["fm"]
    if sigma == 4:
        syms = jsj.bwt_from_planes(np.asarray(fm.lanes), fm.block.num_planes, fm.text_len)
    else:
        syms = np.random.default_rng(sigma).integers(0, sigma, fm.text_len).astype(np.uint8)
    ref = jsj.build_stream_table(sigma, syms, T)
    rw_ref = jsj._layout(sigma, T)[0]
    lifted = ref.view(np.uint32).reshape(-1, rw_ref, T).copy()
    lifted[:, :sigma, :] = _lift_u32(lifted[:, :sigma, :], lift)
    lifted = lifted.reshape(ref.shape).view(np.int32)
    rows = tsj.stream_rows(fm.text_len)
    port = [torch.from_numpy(tsj.stream_table_from_reference(t, sigma, T)[:rows].copy())
            for t in (ref, lifted)]
    return ref, lifted, port[0], port[1]


def _keys(fm, rng, B=600):
    s = int(fm.sentinel_index)
    return np.concatenate([[0, s - 1, s, s + 1, fm.text_len, 7, 7],
                           rng.integers(0, fm.text_len + 1, size=B - 7)]).astype(np.int64)


@pytest.mark.parametrize("lift", list(LIFTS), ids=list(LIFTS))
@pytest.mark.parametrize("sigma", [4, 16])
def test_join_on_a_lifted_stream_table(index, sigma, lift):
    fm = index["fm"]
    off = LIFTS[lift]
    ref, lifted, base_t, lift_t = _stream_tables(index, sigma, off)
    assert bool((trank.u32(lift_t[:, :sigma]) >= HIGH).all())
    assert int(lift_t[:, :sigma].min()) < 0  # the words read negative as int32
    rng = np.random.default_rng(sigma + off % 97)
    pos = _keys(fm, rng)
    sym = rng.integers(0, sigma, size=pos.shape[0]).astype(np.int64)
    sentinel = int(fm.sentinel_index)
    jmeta = dataclasses.replace(index["jdev"].meta, sigma=sigma, stream_rows=ref.shape[0])
    jsent = jnp.asarray(sentinel, jnp.uint32)

    # rank: the JAX kernel on the lifted table, the port's sorted entry and
    # its plain join, and the unlifted answer plus the lift
    want = np.asarray(jsj.rank_next_sorted(
        jmeta, jnp.asarray(lifted), jsent, jnp.asarray(pos, jnp.uint32),
        jnp.asarray(sym, jnp.int32), T=T, C=1024)).astype(np.int64)
    got = tsj.rank_next_sorted(lift_t, sentinel, torch.from_numpy(pos),
                               torch.from_numpy(sym), sigma).numpy()
    base = tsj.rank_next_sorted(base_t, sentinel, torch.from_numpy(pos),
                                torch.from_numpy(sym), sigma).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, base + off)
    assert got.max() < 2**32 and (got >= HIGH).all()
    key = torch.sort(torch.from_numpy(pos + (pos < sentinel)))[0]
    pay = torch.from_numpy(rng.integers(0, sigma, size=key.shape[0]))
    plain, _ = tsj.join_plain(lift_t, key, pay, sigma, False)
    plain0, _ = tsj.join_plain(base_t, key, pay, sigma, False)
    np.testing.assert_array_equal(plain.numpy(), plain0.numpy() + off)

    # decode
    pos = pos[pos < fm.text_len]
    w_rank, w_sym, w_sent = (np.asarray(a) for a in jsj.pre_rank_and_symidx_sorted(
        jmeta, jnp.asarray(lifted), jsent, jnp.asarray(pos, jnp.uint32), T=T, C=1024))
    g_rank, g_sym, g_sent = (t.numpy() for t in tsj.pre_rank_and_symidx_sorted(
        lift_t, sentinel, torch.from_numpy(pos), sigma))
    b_rank, b_sym, _ = (t.numpy() for t in tsj.pre_rank_and_symidx_sorted(
        base_t, sentinel, torch.from_numpy(pos), sigma))
    np.testing.assert_array_equal(g_sent, w_sent)
    keep = ~w_sent
    np.testing.assert_array_equal(g_rank[keep], w_rank[keep].astype(np.int64))
    np.testing.assert_array_equal(g_sym[keep], w_sym[keep].astype(np.int64))
    np.testing.assert_array_equal(g_rank[keep], b_rank[keep] + off)
    np.testing.assert_array_equal(g_sym, b_sym)


# ----------------------------------------------------------------------
# the gather engine's row math
# ----------------------------------------------------------------------

@pytest.mark.parametrize("lift", list(LIFTS), ids=list(LIFTS))
def test_rank_from_lifted_fused_rows(index, lift):
    fm, jdev, tdev = index["fm"], index["jdev"], index["tdev"]
    off = LIFTS[lift]
    sigma = tdev.meta.sigma
    fused = np.asarray(jdev.fused).view(np.uint32).copy()
    np.testing.assert_array_equal(fused.view(np.int32), tdev.fused.numpy())
    fused[:, :sigma] = _lift_u32(fused[:, :sigma], off)
    rng = np.random.default_rng(off % 101)
    q = rng.integers(0, fused.shape[0], size=500)
    rem = rng.integers(0, fm.block.block_len, size=500).astype(np.int64)
    sym = rng.integers(0, sigma, size=500).astype(np.int64)
    rows = fused[q]
    t_rows = torch.from_numpy(rows.view(np.int32))
    want = np.asarray(jrank.rank_from_rows(jdev.meta, jnp.asarray(rows),
                                           jnp.asarray(rem, jnp.uint32),
                                           jnp.asarray(sym, jnp.int32))).astype(np.int64)
    got = trank.rank_from_rows(tdev.meta, t_rows, torch.from_numpy(rem),
                               torch.from_numpy(sym)).numpy()
    base = trank.rank_from_rows(tdev.meta, tdev.fused[torch.from_numpy(q)],
                                torch.from_numpy(rem), torch.from_numpy(sym)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, base + off)
    w_rank, w_sym = (np.asarray(a) for a in jrank.pre_rank_and_symidx_from_rows(
        jdev.meta, jnp.asarray(rows), jnp.asarray(rem, jnp.uint32)))
    g_rank, g_sym = (t.numpy() for t in trank.pre_rank_and_symidx_from_rows(
        tdev.meta, t_rows, torch.from_numpy(rem)))
    b_rank, _ = (t.numpy() for t in trank.pre_rank_and_symidx_from_rows(
        tdev.meta, tdev.fused[torch.from_numpy(q)], torch.from_numpy(rem)))
    np.testing.assert_array_equal(g_rank, w_rank.astype(np.int64))
    np.testing.assert_array_equal(g_sym, w_sym.astype(np.int64))
    np.testing.assert_array_equal(g_rank, b_rank + off)


# ----------------------------------------------------------------------
# locate: expand, the full-SA gather and the walk
# ----------------------------------------------------------------------

def test_expand_ranges_above_2_31():
    rng = np.random.default_rng(5)
    B = 300
    lo = rng.integers(HIGH - 50, 2**32 - 10, size=B).astype(np.int64)
    lo[:3] = [HIGH - 1, HIGH, 2**32 - 8]
    hi = lo + rng.integers(0, 6, size=B)
    for cap in (B, B + 64, B + 1024):
        want = [np.asarray(a) for a in jlocate.expand_ranges(
            jnp.asarray(lo, jnp.uint32), jnp.asarray(hi, jnp.uint32), cap)]
        got = [t.numpy() for t in tlocate.expand_ranges(torch.from_numpy(lo),
                                                         torch.from_numpy(hi), cap)]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.astype(g.dtype))
        rows, _, valid, _ = got
        assert (rows[valid] >= HIGH - 50).all() and (rows[valid] >= HIGH).any()


def test_locate_rows_full_sa_values_above_2_31(index):
    jdev, tdev = index["jdev"], index["tdev"]
    rng = np.random.default_rng(6)
    n = index["fm"].text_len
    sa = rng.integers(HIGH, 2**32, size=n).astype(np.uint32)
    sa[:2] = [HIGH, 2**32 - 1]
    lo = rng.integers(0, n - 8, size=200).astype(np.int64)
    hi = lo + rng.integers(0, 5, size=200)
    lo[:2], hi[:2] = [0, 0], [2, 1]
    jmeta = dataclasses.replace(jdev.meta, has_sa_full=True)
    tmeta = dataclasses.replace(tdev.meta, has_sa_full=True)
    cap = 200 + 512
    w_locs, w_pids, w_valid, _ = (np.asarray(a) for a in jlocate.locate_rows(
        jmeta, jdev.fused, jdev.count_arr, jnp.asarray(sa), jdev.sentinel,
        jnp.asarray(lo, jnp.uint32), jnp.asarray(hi, jnp.uint32), cap))
    g_locs, g_pids, g_valid, _ = (t.numpy() for t in tlocate.locate_rows(
        tmeta, tdev.fused, tdev.count_arr, torch.from_numpy(sa.view(np.int32)), tdev.sentinel,
        torch.from_numpy(lo), torch.from_numpy(hi), cap))
    np.testing.assert_array_equal(g_valid, w_valid)
    np.testing.assert_array_equal(g_locs, w_locs.astype(np.int64))
    np.testing.assert_array_equal(g_pids, w_pids.astype(np.int64))
    assert (g_locs[g_valid] >= HIGH).all() and 2**32 - 1 in g_locs[g_valid]


@pytest.mark.parametrize("use_stream", [False, True], ids=["gather", "stream"])
def test_walk_with_sampled_sa_values_above_2_31(index, use_stream):
    fm, jdev, tdev = index["fm"], index["jdev"], index["tdev"]
    off = LIFTS["top"]  # the largest SA value plus the largest offset stays below 2^32
    sa = np.asarray(fm.suffix_array).astype(np.uint32)
    sa_lift = _lift_u32(sa, off - fm.sampling_ratio)
    rng = np.random.default_rng(7)
    rows = rng.integers(0, fm.text_len, size=400).astype(np.int64)
    rows[:3] = [0, int(fm.sentinel_index) - 1, fm.text_len - 1]
    valid = np.ones(400, bool)
    valid[5] = False
    kw = dict(stream_tbl=jdev.stream_tbl, use_stream=use_stream)
    want = np.asarray(jlocate.walk_rows(
        jdev.meta, jdev.fused, jdev.count_arr, jnp.asarray(sa_lift), jdev.sentinel,
        jnp.asarray(rows, jnp.uint32), jnp.asarray(valid), **kw)).astype(np.int64)
    args = (tdev.meta, tdev.fused, tdev.count_arr)
    tail = (tdev.sentinel, torch.from_numpy(rows), torch.from_numpy(valid), tdev.stream_tbl,
            use_stream)
    got = tlocate.walk_rows(*args, torch.from_numpy(sa_lift.view(np.int32)), *tail).numpy()
    base = tlocate.walk_rows(*args, torch.from_numpy(sa.view(np.int32)), *tail).numpy()
    np.testing.assert_array_equal(got[valid], want[valid])
    # a walk that meets the sentinel row reads no SA value: it keeps its offset
    diff = got[valid] - base[valid]
    assert set(np.unique(diff)) <= {0, off - fm.sampling_ratio}
    assert (got[valid] >= HIGH).sum() >= valid.sum() - 2 and got.max() < 2**32


# ----------------------------------------------------------------------
# seeds and state
# ----------------------------------------------------------------------

@pytest.mark.parametrize("all_dense", [False, True])
def test_initial_range_with_dense_seeds_above_2_31(index, all_dense):
    fm, jdev, tdev = index["fm"], index["jdev"], index["tdev"]
    dk, sigma = 5, 4
    rng = np.random.default_rng(8 + all_dense)
    d_lo = rng.integers(HIGH, 2**32 - 100, size=sigma**dk).astype(np.uint32)
    d_lo[:2] = [HIGH, 2**32 - 100]
    d_hi = (d_lo.astype(np.int64) + rng.integers(0, 50, size=d_lo.shape[0])).astype(np.uint32)
    B, L = 120, 12
    sym = rng.integers(0, sigma, size=(B, L)).astype(np.int64)
    lens = np.full(B, L, np.int64) if all_dense else rng.integers(1, L + 1, size=B)
    jmeta = dataclasses.replace(jdev.meta, dense_k=dk)
    tmeta = dataclasses.replace(tdev.meta, dense_k=dk)
    want = [np.asarray(a).astype(np.int64) for a in jsearch.initial_range(
        jmeta, jdev.kmer_tbl, jnp.asarray(d_lo), jnp.asarray(d_hi), jnp.asarray(sym, jnp.int32),
        jnp.asarray(lens, jnp.int32), all_dense=all_dense)]
    got = [t.numpy() for t in tsearch.initial_range(
        tmeta, tdev.kmer_tbl, torch.from_numpy(d_lo.view(np.int32)),
        torch.from_numpy(d_hi.view(np.int32)), torch.from_numpy(sym), torch.from_numpy(lens),
        all_dense=all_dense)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    dense = lens >= dk
    assert dense.any() and (got[0][dense] >= HIGH).all() and (got[1][dense] >= HIGH).all()


def test_from_reference_keeps_j_star_and_c2_above_2_31(index):
    fm = index["fm"]
    jdev = fm.to_device(dense_lut_entries=4**5, dense_host_entries=4**4, stream_tile=T)
    arrays = {f.name: np.asarray(getattr(jdev, f.name))
              for f in dataclasses.fields(jdev) if f.name != "meta"}
    assert arrays["pair_fix"].dtype == np.uint32
    j_star, c_star = HIGH + 5, int(arrays["pair_fix"][1])
    arrays["pair_fix"] = np.array([j_star, c_star], np.uint32)
    arrays["pair_c2"] = _lift_u32(arrays["pair_c2"].view(np.uint32), HIGH)
    arrays["dense_lo"] = _lift_u32(arrays["dense_lo"].view(np.uint32), HIGH)
    rdev = DeviceFmIndex.from_reference(arrays, jdev.meta, device="cpu")
    assert rdev.pair_fix.tolist() == [j_star, c_star]
    assert rdev.pair_c2.dtype == torch.int64 and bool((rdev.pair_c2 >= HIGH).all())
    np.testing.assert_array_equal(trank.u32(rdev.dense_lo).numpy(),
                                  arrays["dense_lo"].astype(np.int64))


# ----------------------------------------------------------------------
# the SA fill's piecewise passes
# ----------------------------------------------------------------------

def _corpus_u32():
    import base64
    import json

    with open(os.path.join(CORPUS, "corpus.json")) as f:
        cases = json.load(f)["cases"]
    out = []
    for c in cases:
        if c["position"] != "u32" or c["sampling_ratio_config"] < 2:
            continue
        blob = np.fromfile(os.path.join(CORPUS, c["blob"]), dtype=np.uint8)
        out.append(pytest.param(c, blob, base64.b64decode(c["text"]), id=c["name"]))
    return out


@pytest.mark.parametrize("case,blob,text", _corpus_u32())
@pytest.mark.parametrize("ratio", [1, 3])
def test_sa_fill_in_pieces_of_seven(monkeypatch, case, blob, text, ratio):
    fm = ft.FmIndex.load(blob, position="u32", block=getattr(ft, case["block"]),
                         encoder_kind=case["encoder"])
    kw = dict(sa_full="device", sa_fill_ratio=ratio, dense_lut_entries=0)
    whole = to_device_torch(fm, "cpu", **kw).sa
    monkeypatch.setattr(sa_fill, "_PIECE", 7)
    pieces = to_device_torch(fm, "cpu", **kw).sa
    assert torch.equal(pieces, whole)
    # the full SA: every suffix of the encoded text once, in order
    sa = trank.u32(whole).numpy()
    assert sorted(sa.tolist()) == list(range(len(text)))
    sym = bytes(np.asarray(fm.encoder.encode(np.frombuffer(text, np.uint8)), np.uint8))
    suffixes = [sym[i:] for i in sa]
    assert suffixes == sorted(suffixes)
    # the seed writes the same rows piece by piece
    R = fm.sampling_ratio * ratio
    sa_up = torch.from_numpy(np.asarray(fm.suffix_array[::ratio]).astype(np.int64))
    out7 = sa_fill._seed(sa_up, fm.text_len, R)
    monkeypatch.setattr(sa_fill, "_PIECE", 1 << 28)
    out = sa_fill._seed(sa_up, fm.text_len, R)
    assert torch.equal(out7, out)
    assert torch.equal(trank.u32(out[::R]), sa_up)


@pytest.mark.parametrize("n", [0, 1, 6, 7, 8, 50, 141])
def test_unfilled_rows_in_pieces(monkeypatch, n):
    rng = np.random.default_rng(n)
    words = rng.integers(-2**31, 2**31, size=n).astype(np.int32)
    words[words == -1] = 0
    planted = rng.choice(n, size=min(n, 9), replace=False) if n else np.zeros(0, np.int64)
    words[planted] = -1
    if n >= 8:  # both sides of a piece boundary, and the last row
        words[[6, 7, n - 1]] = -1
    out = torch.from_numpy(words)
    want = torch.nonzero(trank.u32(out) == sa_fill.UNFILLED)[:, 0]
    monkeypatch.setattr(sa_fill, "_PIECE", 7)
    got = sa_fill.unfilled_rows(out)
    assert got.dtype == torch.int64 and torch.equal(got, want)
    monkeypatch.setattr(sa_fill, "_PIECE", 1 << 28)
    assert torch.equal(sa_fill.unfilled_rows(out), want)


# ----------------------------------------------------------------------
# the smoke run's opt-in sizes and the shared text generator
# ----------------------------------------------------------------------

@pytest.mark.parametrize("narrow,wide,ok", [
    (0, 0, True), (3_100_000_000, 0, True), (2**31 + 2**20 + 1, 0, True),
    (2**32 - 2**20 - 1, 0, True), (0, 4_500_000_000, True),
    (2**32 - 2**20, 0, True), (2**32 - 2**24, 0, True), (2**32 - 1, 0, True),
    (2**31, 0, False), (2**31 + 2**20, 0, False), (2**32, 0, False),
    (1_000_000_000, 0, False), (5_000_000_000, 0, False),
    (3_100_000_000, 4_500_000_000, False), (0, 2**32, False)])
def test_opt_in_size_guard(narrow, wide, ok):
    if ok:
        chip_smoke.opt_in_sizes(narrow, wide)
    else:
        with pytest.raises(RuntimeError, match="SMOKE_"):
            chip_smoke.opt_in_sizes(narrow, wide)


@pytest.mark.parametrize("size", [1000, 4096, 4097, 10_000])
def test_one_text_generator(monkeypatch, tmp_path, size):
    """Above the one-draw threshold (patched to 4096, chunks of 1000) both
    scripts write the chunked bytes under one name; at or below it the one
    draw of every cached text."""
    monkeypatch.setattr(bench_torch, "TEXT_ONE_DRAW", 4096)
    monkeypatch.setattr(bench_torch, "TEXT_CHUNK", 1000)
    monkeypatch.setattr(chip_smoke, "CACHE_DIR", str(tmp_path / "smoke"))
    a = chip_smoke.get_text(size)
    b = bench_torch.get_text(size, str(tmp_path / "bench"))
    assert os.path.basename(a.filename) == os.path.basename(b.filename) == f"text_{size}_42.bin"
    assert a.tobytes() == b.tobytes() and len(a) == size
    acgt = np.frombuffer(b"ACGT", np.uint8)
    rng = np.random.default_rng(42)
    if size <= 4096:
        want = acgt[rng.integers(0, 4, size=size)]
    else:
        want = np.concatenate([acgt[rng.integers(0, 4, size=min(1000, size - s), dtype=np.uint8)]
                               for s in range(0, size, 1000)])
    assert a.tobytes() == want.tobytes()
