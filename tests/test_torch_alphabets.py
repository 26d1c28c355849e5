"""Port parity beyond DNA: every alphabet the JAX package sends through its
join kernel (sigma <= 63 for the stream table, sigma^2 <= 63 for the pair
table).

Two indexes, made from seeded numpy generators at a few thousand symbols:

- wildcard DNA: ``EncodingTable.from_symbols_with_wildcard`` over ACGT, so
  N and every other byte is a fifth symbol (sigma 5, pair table sigma^2 25),
  Block3<u64>, r=2, k=3, as the interop corpus case ``wild_b3u64_k3r2``;
- protein: the 20 amino acids (sigma 20, no pair table), Block5<u64>, r=2,
  k=2, as ``prot_b5u64_k2r2`` and BASELINE config 4.

Both must upload the same tables the JAX package uploads (the gate), rank
and decode as its Pallas kernel does (interpret mode), and answer counts,
ranges and per-pattern locations as the JAX index and the host oracle do:
mixed 10-30 lengths on the protein index (the per-step stream path),
uniform lengths through the sorted pair chain on the wildcard index, the
wide engine at sigma 20.  Exact equality throughout.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import sview_fmindex_tpu as fmx  # noqa: E402
from sview_fmindex_tpu.build.dense_lut import dense_lut  # noqa: E402
from sview_fmindex_tpu.models.device_index import DeviceFmIndex as JaxDeviceFmIndex  # noqa: E402
from sview_fmindex_tpu.ops import stream_join as jsj  # noqa: E402
from sview_fmindex_tpu.ops.wide import combine64  # noqa: E402
from sview_fmindex_tpu.utils.patterns import pack_patterns  # noqa: E402
from sview_fmindex_tpu_torch import DeviceFmIndex, to_device_torch  # noqa: E402
from sview_fmindex_tpu_torch.ops import stream_join as tsj  # noqa: E402

T = 256  # reference stream tile
AMINO = b"ARNDCQEGHILKMFPSTWYV"
# wildcard DNA: dense_k 5, four levels built on the host and one on the device
WILD_DENSE = dict(dense_lut_entries=5 ** 5, dense_host_entries=5 ** 4)
PROT_DENSE = dict(dense_lut_entries=20 ** 3, dense_host_entries=20 ** 2)  # dense_k 3
_cache = {}


def _wild_text(n, rng):
    """ACGT with runs of N (about 3% of the text, 10-60 bp each, like an
    assembly's gaps) and a few other bytes outside the alphabet."""
    text = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=n)].copy()
    for start in rng.integers(0, n - 60, size=3):
        text[start:start + rng.integers(10, 60)] = ord("N")
    text[rng.integers(0, n, size=5)] = np.frombuffer(b"R~?Yn", np.uint8)
    return text.tobytes()


def _build(name):
    if name in _cache:
        return _cache[name]
    if name == "wild5":
        rng = np.random.default_rng(55)
        text = _wild_text(3000, rng)
        enc = fmx.EncodingTable.from_symbols_with_wildcard([b"A", b"C", b"G", b"T"])
        block, k, dense = fmx.BLOCK3_U64, 3, WILD_DENSE
    else:
        rng = np.random.default_rng(20)
        text = np.frombuffer(AMINO, np.uint8)[rng.integers(0, 20, size=6000)].tobytes()
        enc = fmx.EncodingTable.from_symbols([bytes([c]) for c in AMINO])
        block, k, dense = fmx.BLOCK5_U64, 2, PROT_DENSE
    b = fmx.FmIndexBuilder(
        len(text), enc.symbol_count(), enc, position="u32", block=block,
        suffix_array_config=fmx.SuffixArrayConfig.compressed(2),
        lookup_table_config=fmx.LookupTableConfig.kmer_size(k), sa_backend="numpy")
    fm = fmx.FmIndex.load(np.frombuffer(b.build(text), np.uint8), position="u32", block=block)
    jdev = fm.to_device(sa_full="device", stream_tile=T, **dense)
    tdev = to_device_torch(fm, "cpu", sa_full="device", **dense)
    _cache[name] = dict(text=text, fm=fm, jdev=jdev, tdev=tdev, dense=dense)
    return _cache[name]


def _arrays(jdev):
    return {f.name: np.asarray(getattr(jdev, f.name))
            for f in dataclasses.fields(jdev) if f.name != "meta"}


ALPHABETS = ["wild5", "prot20"]


@pytest.mark.parametrize("name", ALPHABETS)
def test_join_tables_gated_as_in_reference(name):
    """The port uploads a stream table wherever the JAX package does
    (sigma <= 63) and a pair table where sigma^2 <= 63, from its own upload
    and from the JAX index's state, narrow and wide; ``engine_for`` names
    the same engine at every batch size."""
    ix = _build(name)
    fm, jdev, tdev = ix["fm"], ix["jdev"], ix["tdev"]
    sigma = fm.symbol_count
    assert jdev.meta.stream_rows > 0 and (jdev.meta.pair_rows > 0) == (sigma == 5)
    rdev = DeviceFmIndex.from_reference(_arrays(jdev), jdev.meta, device="cpu")
    for dev in (tdev, rdev):
        assert dev.meta.stream_rows == tsj.stream_rows(fm.text_len)
        assert (dev.meta.pair_rows > 0) == (sigma == 5)
        assert dev.stream_tbl.shape == (tsj.stream_rows(fm.text_len), tsj._rw(sigma))
        for B in (100, tdev.STREAM_MIN_BATCH - 1, tdev.STREAM_MIN_BATCH, 1 << 20):
            for use_stream in (None, True, False):
                assert dev.engine_for(B, use_stream) == jdev.engine_for(B, use_stream), B
    jwide = JaxDeviceFmIndex.from_host(fm, force_wide=True, dense_lut_entries=0)
    twide = to_device_torch(fm, "cpu", force_wide=True, dense_lut_entries=0)
    assert jwide.meta.stream_rows > 0 and twide.meta.stream_rows > 0
    assert twide.engine_for(100) == jwide.engine_for(100) == "wide-stream"


@pytest.mark.parametrize("name", ALPHABETS)
def test_tables_match_adapted_reference(name):
    """Stream (and pair) table, C2 and the sentinel-target entry equal the
    JAX package's after the layout adapter, padding words zero; so does
    the state carried over from the JAX index."""
    ix = _build(name)
    fm, jdev, tdev = ix["fm"], ix["jdev"], ix["tdev"]
    sigma, rows = fm.symbol_count, tsj.stream_rows(fm.text_len)
    tables = [("stream_tbl", sigma)] + ([("pair_tbl", sigma * sigma)] if sigma == 5 else [])
    for field, s in tables:
        got = getattr(tdev, field).numpy()
        want = tsj.stream_table_from_reference(np.asarray(getattr(jdev, field)), s, T)
        np.testing.assert_array_equal(got, want[:rows], err_msg=field)
        assert not got[:, s:tsj._plane_off(s)].any()
    if sigma == 5:
        np.testing.assert_array_equal(tdev.pair_c2.numpy(), np.asarray(jdev.pair_c2))
        np.testing.assert_array_equal(tdev.pair_fix.numpy(), np.asarray(jdev.pair_fix))
    rdev = DeviceFmIndex.from_reference(_arrays(jdev), jdev.meta, device="cpu")
    assert rdev.meta == tdev.meta
    for field in ("fused", "stream_tbl", "pair_tbl", "sa", "dense_lo", "dense_hi",
                  "pair_c2", "pair_fix"):
        a, b = getattr(rdev, field), getattr(tdev, field)
        assert (a is None and b is None) or torch.equal(a, b), field


def test_pair_ranks_never_read_padding_codes():
    """At sigma^2 = 25 the padding code 25 (0b11001) sets plane bits past n,
    and no rank reads them: at every key p in [0, n] the ranks of all 25
    codes sum to p."""
    ix = _build("wild5")
    tdev, n = ix["tdev"], ix["fm"].text_len
    tbl = tdev.pair_tbl
    last = tbl[-1, tsj._plane_off(25):].view(-1, 4)  # planes x lanes of the last block
    rem = n % 128
    assert rem and any(int(w) & 1 for w in last[0]), "padding bits expected at 25 codes"
    keys = torch.arange(n + 1).repeat_interleave(25)
    codes = torch.arange(25).repeat(n + 1)
    ranks, _ = tsj.join(tbl, keys, codes, 25, False)
    assert torch.equal(ranks.view(n + 1, 25).sum(1), torch.arange(n + 1))


def _positions(fm, rng, B=600):
    s = fm.sentinel_index
    return np.concatenate([[0, s - 1, s, s + 1, fm.text_len, 5, 5, 5],
                           rng.integers(0, fm.text_len + 1, size=B - 8)]).astype(np.int64)


@pytest.mark.parametrize("decode", [False, True], ids=["rank", "decode"])
@pytest.mark.parametrize("name,pair", [("wild5", False), ("wild5", True), ("prot20", False)],
                         ids=["sigma5", "pair25", "sigma20"])
def test_sorted_join_matches_reference(name, pair, decode):
    """``rank_next_sorted`` / ``pre_rank_and_symidx_sorted`` against the
    JAX kernel's (interpret mode), duplicate keys and key n included."""
    ix = _build(name)
    fm, jdev, tdev = ix["fm"], ix["jdev"], ix["tdev"]
    rng = np.random.default_rng(7 + pair + 2 * decode)
    sigma = fm.symbol_count
    if pair:
        sigma, jtbl, ttbl = sigma * sigma, jdev.pair_tbl, tdev.pair_tbl
        jmeta = dataclasses.replace(jdev.meta, sigma=sigma, stream_rows=jdev.meta.pair_rows)
    else:
        jtbl, ttbl, jmeta = jdev.stream_tbl, tdev.stream_tbl, jdev.meta
    pos = _positions(fm, rng)
    if decode:
        pos = pos[pos < fm.text_len]
        w_rank, w_sym, w_sent = (np.asarray(a) for a in jsj.pre_rank_and_symidx_sorted(
            jmeta, jtbl, jdev.sentinel, jnp.asarray(pos, jnp.uint32), T=T, C=1024))
        g_rank, g_sym, g_sent = (t.numpy() for t in tsj.pre_rank_and_symidx_sorted(
            ttbl, tdev.sentinel, torch.from_numpy(pos), sigma))
        np.testing.assert_array_equal(g_sent, w_sent)
        keep = ~w_sent
        np.testing.assert_array_equal(g_rank[keep], w_rank[keep].astype(np.int64))
        np.testing.assert_array_equal(g_sym[keep], w_sym[keep].astype(np.int64))
    else:
        sym = rng.integers(0, sigma, size=pos.shape[0]).astype(np.int64)
        want = np.asarray(jsj.rank_next_sorted(
            jmeta, jtbl, jdev.sentinel, jnp.asarray(pos, jnp.uint32),
            jnp.asarray(sym, jnp.int32), T=T, C=1024))
        got = tsj.rank_next_sorted(ttbl, tdev.sentinel, torch.from_numpy(pos),
                                   torch.from_numpy(sym), sigma)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def _batch(text, rng, lens, B):
    starts = rng.integers(0, len(text) - max(lens), size=B)
    pats = [text[s:s + m] for s, m in zip(starts, rng.choice(lens, size=B))]
    return pats, *pack_patterns(pats)


def _assert_same(fm, tdev, jdev, pats, batch, lens, use_stream, use_pair=True):
    """Counts, ranges and locations of the port against the JAX index (its
    default engine: gather at these batch sizes) and the host oracle."""
    c = tdev.count(batch, lens, use_stream=use_stream, use_pair=use_pair).numpy()
    np.testing.assert_array_equal(c, np.asarray(jdev.count(batch, lens)).astype(np.int64))
    np.testing.assert_array_equal(c, [fm.count(p) for p in pats])
    # a non-empty range is the same BWT interval on every engine; where an
    # empty one stops depends on the engine (the gather loop masks it, the
    # sorted chain steps on), so only its emptiness is compared
    lo, hi = (t.numpy() for t in tdev.pos_ranges(batch, lens, use_stream=use_stream))
    jlo, jhi = (np.asarray(a).astype(np.int64) for a in jdev.pos_ranges(batch, lens))
    np.testing.assert_array_equal(hi - lo, c)
    np.testing.assert_array_equal(lo[c > 0], jlo[c > 0])
    np.testing.assert_array_equal(hi[c > 0], jhi[c > 0])
    locs, pids, valid, counts, dropped = tdev.locate_with_counts(
        batch, lens, use_stream=use_stream, use_pair=use_pair)
    assert int(dropped[0]) == 0 and torch.equal(counts, torch.from_numpy(c))
    jl, jp, jv, _ = (np.asarray(a) for a in jdev.locate(batch, lens, capacity=locs.shape[0]))
    np.testing.assert_array_equal(valid.numpy(), jv)
    np.testing.assert_array_equal(locs.numpy()[jv], jl[jv].astype(np.int64))
    np.testing.assert_array_equal(pids.numpy()[jv], jp[jv].astype(np.int64))
    for i, p in enumerate(pats):
        assert sorted(locs[valid & (pids == i)].tolist()) == sorted(fm.locate(p)), i


@pytest.mark.parametrize("use_stream", [True, False], ids=["stream", "gather"])
def test_protein_mixed_lengths(use_stream, monkeypatch):
    """BASELINE config 4's traffic: 10-30 aa patterns of mixed length take
    the per-step path (one sort, join and unsort per LF step) on the stream
    engine, through the join's rank mode at sigma 20."""
    ix = _build("prot20")
    fm, tdev, jdev = ix["fm"], ix["tdev"], ix["jdev"]
    pats, batch, lens = _batch(ix["text"], np.random.default_rng(3), np.arange(10, 31), 200)
    pats[5] = b"W" * 12  # absent
    batch, lens = pack_patterns(pats)
    assert tdev.engine_for(200, use_stream) == ("stream" if use_stream else "gather")
    sigmas = []
    plain = tsj.join_plain
    monkeypatch.setattr(tsj, "join_plain", lambda t, k, p, s, *a: sigmas.append(s) or plain(
        t, k, p, s, *a))
    _assert_same(fm, tdev, jdev, pats, batch, lens, use_stream)
    assert (20 in sigmas) == use_stream


@pytest.mark.parametrize("plen", [9, 10, 4], ids=["even_steps", "odd_steps", "blob_seed"])
def test_wildcard_dna_pair_chain(plen):
    """Uniform lengths through the sorted pair chain over the 25-code pair
    table (plus its odd pass over the sigma-5 table), patterns holding the
    wildcard (N runs and other bytes) among them; the gather engine and the
    oracle agree."""
    ix = _build("wild5")
    fm, tdev, jdev, text = ix["fm"], ix["tdev"], ix["jdev"], ix["text"]
    rng = np.random.default_rng(plen)
    pats, batch, lens = _batch(text, rng, [plen], 250)
    n_at = text.index(b"N")  # a pattern straddling the first N run
    pats[:3] = [text[n_at - 2:n_at - 2 + plen], b"N" * plen, b"A" * (plen - 1) + b"~"]
    batch, lens = pack_patterns(pats)
    assert tdev.engine_for(250, use_stream=True) == "pair-stream"
    for use_stream in (True, False):
        _assert_same(fm, tdev, jdev, pats, batch, lens, use_stream)


def test_wildcard_dna_mixed_lengths():
    """Mixed lengths on the pair table (the per-step pair loop and its odd
    leftover steps) and the single-symbol stream engine."""
    ix = _build("wild5")
    fm, tdev, jdev, text = ix["fm"], ix["tdev"], ix["jdev"], ix["text"]
    pats, _, _ = _batch(text, np.random.default_rng(11), np.arange(1, 16), 200)
    pats += [b"N", b"NN", b"ACGTN", b"aNNt", b"~~~~~~"]
    batch, lens = pack_patterns(pats)
    for use_pair in (True, False):
        _assert_same(fm, tdev, jdev, pats, batch, lens, True, use_pair)


def test_stream_decode_walk_at_sigma_5_and_20():
    """No full SA: the LF walk decodes through the join's decode mode."""
    for name in ALPHABETS:
        ix = _build(name)
        fm, jdev = ix["fm"], ix["jdev"]
        walk = to_device_torch(fm, "cpu", **ix["dense"])
        assert not walk.meta.has_sa_full
        pats, batch, lens = _batch(ix["text"], np.random.default_rng(4), [10, 12], 150)
        _assert_same(fm, walk, jdev, pats, batch, lens, True)


def test_dense_extension_at_sigma_20():
    """dense_k 4 at sigma 20 (as dense_k 6 on the chip): levels 3 on the
    host, 1 on the device.  Every seed range equals the host table's; an
    empty range may carry other bounds, as in the JAX extension."""
    rng = np.random.default_rng(21)
    text = np.frombuffer(AMINO, np.uint8)[rng.integers(0, 20, size=40_000)].tobytes()
    enc = fmx.EncodingTable.from_symbols([bytes([c]) for c in AMINO])
    b = fmx.FmIndexBuilder(
        len(text), 20, enc, position="u32", block=fmx.BLOCK5_U64,
        suffix_array_config=fmx.SuffixArrayConfig.compressed(2),
        lookup_table_config=fmx.LookupTableConfig.kmer_size(2), sa_backend="numpy")
    fm = fmx.FmIndex.load(np.frombuffer(b.build(text), np.uint8), position="u32",
                          block=fmx.BLOCK5_U64)
    dev = to_device_torch(fm, "cpu", dense_lut_entries=20 ** 4, dense_host_entries=20 ** 3)
    assert dev.meta.dense_k == 4 and dev.meta.stream_rows > 0
    lo, hi = (np.asarray(a).astype(np.int64) for a in dense_lut(fm, 4))
    got_lo, got_hi = (t.numpy().astype(np.int64) & 0xFFFFFFFF for t in (dev.dense_lo, dev.dense_hi))
    np.testing.assert_array_equal(got_hi - got_lo, hi - lo)
    full = hi > lo
    np.testing.assert_array_equal(got_lo[full], lo[full])


def test_force_wide_protein_matches_reference():
    """The wide engine at sigma 20 (segmented rank and decode modes, the
    per-step stream path for mixed lengths) against the JAX wide index."""
    ix = _build("prot20")
    fm = ix["fm"]
    jwide = JaxDeviceFmIndex.from_host(fm, force_wide=True)
    twide = to_device_torch(fm, "cpu", force_wide=True)
    assert twide.meta.wide_pos and twide.meta.dense_k == jwide.meta.dense_k > 0
    assert twide.seg_base.shape == (1, 20)
    for lens in (np.arange(10, 31), [12]):
        pats, batch, blens = _batch(ix["text"], np.random.default_rng(len(lens)), lens, 120)
        want = combine64(*np.asarray(jwide.count(batch, blens, use_stream=False)))
        np.testing.assert_array_equal(want, [fm.count(p) for p in pats])
        for use_stream in (True, False):
            c = twide.count(batch, blens, use_stream=use_stream)
            np.testing.assert_array_equal(c.numpy(), want)
            locs, pids, valid, _, dropped = twide.locate_with_counts(
                batch, blens, use_stream=use_stream)
            assert int(dropped[0]) == 0
            jl, jp, jv, _ = (np.asarray(a) for a in jwide.locate(
                batch, blens, capacity=locs.shape[0], use_stream=False))
            np.testing.assert_array_equal(valid.numpy(), jv)
            np.testing.assert_array_equal(locs.numpy()[jv], combine64(jl[0], jl[1])[jv])
            np.testing.assert_array_equal(pids.numpy()[jv], jp[jv])
