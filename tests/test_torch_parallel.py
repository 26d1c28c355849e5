"""Pattern-data-parallel serving of the port (``parallel/query.py``) on 1, 2
and 4 gloo ranks on the CPU, case for case with ``tests/test_parallel.py``.

Each world size is started once per module (``torch_dist_harness``); the
cases read its results.  Everything is exact: counts and location sets equal
the host oracle's, the merged answers do not depend on the number of ranks,
the stream (pair) engine equals the gather engine per shard, every rank
returns the same arrays, and the arrays equal the JAX package's
``ShardedFmIndex`` on the same blob, batch and shard count (its virtual CPU
mesh): shapes, ``valid``, ``pids`` and ``dropped`` everywhere, locations on
the valid slots.
"""
import random
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sview_fmindex_tpu import (  # noqa: E402
    BlockKind,
    EncodingTable,
    FmIndex,
    FmIndexBuilder,
    LookupTableConfig,
    SuffixArrayConfig,
)
from sview_fmindex_tpu.models.device_index import DeviceFmIndex as JaxDeviceFmIndex  # noqa: E402
from sview_fmindex_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from sview_fmindex_tpu.parallel.query import ShardedFmIndex as JaxShardedFmIndex  # noqa: E402
from sview_fmindex_tpu.utils.patterns import pack_patterns  # noqa: E402

import torch_dist_harness as harness  # noqa: E402
from oracle import gen_rand_pattern, gen_rand_symbols, gen_rand_text  # noqa: E402

WORLDS = (1, 2, 4)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The index of tests/test_parallel.py, its batches, and every world's
    results."""
    rng = random.Random(123)
    symbols = gen_rand_symbols(rng, 4)
    text = gen_rand_text(rng, symbols, 2000, 3000)
    enc = EncodingTable.from_symbols(symbols)
    builder = FmIndexBuilder(
        len(text), enc.symbol_count(), enc, block=BlockKind(2, 64),
        suffix_array_config=SuffixArrayConfig.compressed(2),
        lookup_table_config=LookupTableConfig.kmer_size(3))
    blob = bytes(builder.build(text))
    fm = FmIndex.load(np.frombuffer(blob, np.uint8), block=BlockKind(2, 64))
    root = tmp_path_factory.mktemp("dp")
    blob_path = str(root / "index.blob")
    with open(blob_path, "wb") as f:
        f.write(blob)

    def batch(n, lo, hi):
        pats = [gen_rand_pattern(rng, text, lo, hi) for _ in range(n)]
        return (pats,) + pack_patterns(pats)

    batches = {"count101": batch(101, 2, 10), "locate37": batch(37, 2, 8),
               "inv16": batch(16, 2, 8), "stream32": batch(32, 2, 10),
               "fixed23": batch(23, 9, 9)}

    def calls(name, **kw):
        _, b, l = batches[name]
        return [("count", (b, l), kw), ("locate", (b, l), kw), ("pos_ranges", (b, l), kw)]

    dp = {"axis": "dp"}
    cases = [{"name": n, "kind": "sharded", "mesh": dp, "calls": calls(n)}
             for n in ("count101", "locate37", "inv16")]
    _, sb, sl = batches["stream32"]
    cases.append({"name": "stream32", "kind": "sharded", "mesh": dp, "calls": [
        ("count", (sb, sl), {"use_stream": False}), ("count", (sb, sl), {"use_stream": True}),
        ("locate", (sb, sl), {"use_stream": False}), ("locate", (sb, sl), {"use_stream": True})]})
    # one shared length: the sorted pair chain per shard
    cases.append({"name": "fixed23", "kind": "sharded", "mesh": dp,
                  "calls": calls("fixed23", use_stream=True)})
    cases.append({"name": "capacity", "kind": "sharded", "mesh": dp, "calls": [
        ("locate", batches["locate37"][1:], {"capacity_per_shard": 64})]})
    cases.append({"name": "wide", "kind": "sharded", "mesh": dp,
                  "init": {"upload": {"force_wide": True}},
                  "calls": calls("locate37") + calls("locate37", use_stream=False)})
    cases.append({"name": "engine", "kind": "sharded", "mesh": dp, "calls": [
        ("_stream", (40000, None), {}), ("_stream", (140000, None), {}),
        ("_stream", (1000, True), {})]})
    job = {"blob": blob_path, "load": {"block": (2, 64)}, "cases": cases}
    results = {w: harness.run_ranks(w, job, root / f"world{w}") for w in WORLDS}
    return {"fm": fm, "batches": batches, "results": results, "job": job, "root": root}


def _by_pattern(locs, pids, valid):
    by = {}
    for l, p, v in zip(locs, pids, valid):
        if v:
            by.setdefault(int(p), []).append(int(l))
    return by


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_count_matches_host(setup, world):
    fm = setup["fm"]
    pats = setup["batches"]["count101"][0]
    counts = setup["results"][world][0]["count101"]["calls"][0]
    assert counts.shape == (101,) and counts.dtype == np.int64
    assert counts.tolist() == [fm.count(p) for p in pats]


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_locate_matches_host(setup, world):
    fm = setup["fm"]
    pats = setup["batches"]["locate37"][0]
    res = setup["results"][world][0]["locate37"]
    assert res["info"]["n_devices"] == world
    locs, pids, valid, _dropped = res["calls"][1]
    by = _by_pattern(locs, pids, valid)
    for i, p in enumerate(pats):
        assert sorted(by.get(i, [])) == sorted(int(x) for x in fm.locate(p)), (i, p)
    lo, hi = res["calls"][2]
    assert (hi - lo).tolist() == [fm.count(p) for p in pats]


def test_sharding_invariance(setup):
    """Merged results identical for 1, 2 and 4 ranks."""
    merged = []
    for world in WORLDS:
        counts, (locs, pids, valid, _), _ = setup["results"][world][0]["inv16"]["calls"]
        merged.append((counts.tolist(),
                       sorted((int(p), int(l)) for l, p, v in zip(locs, pids, valid) if v)))
    assert all(m == merged[0] for m in merged[1:])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_stream_pair_engine_matches_gather(setup, world):
    """The stream + pair engine forced on must match the gather engine per
    shard, in counts and in located sets (the stream-decode walk)."""
    fm = setup["fm"]
    pats = setup["batches"]["stream32"][0]
    c_gather, c_stream, l_gather, l_stream = setup["results"][world][0]["stream32"]["calls"]
    np.testing.assert_array_equal(c_gather, c_stream)
    assert c_stream.tolist() == [fm.count(p) for p in pats]
    for a, b in zip(l_gather, l_stream):
        np.testing.assert_array_equal(a, b)
    by = _by_pattern(*l_stream[:3])
    for i, p in enumerate(pats):
        assert sorted(by.get(i, [])) == sorted(int(x) for x in fm.locate(p))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_fixed_length_chain(setup, world):
    fm = setup["fm"]
    pats = setup["batches"]["fixed23"][0]
    counts, (locs, pids, valid, dropped), _ = setup["results"][world][0]["fixed23"]["calls"]
    assert counts.tolist() == [fm.count(p) for p in pats]
    by = _by_pattern(locs, pids, valid)
    for i, p in enumerate(pats):
        assert sorted(by.get(i, [])) == sorted(int(x) for x in fm.locate(p))
    assert dropped.shape == (world,)


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_same(setup, world):
    ranks = setup["results"][world]
    assert len(ranks) == world
    for other in ranks[1:]:
        for name, res in ranks[0].items():
            for a, b in zip(res["calls"], other[name]["calls"]):
                for x, y in zip(a if isinstance(a, tuple) else (a,),
                                b if isinstance(b, tuple) else (b,)):
                    np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("world", WORLDS)
def test_engine_choice_is_per_shard(setup, world):
    """``STREAM_MIN_BATCH`` (32768) applies to a rank's share of the batch."""
    auto_40k, auto_140k, forced = setup["results"][world][0]["engine"]["calls"]
    assert auto_40k == (40000 // world >= 32768)
    assert auto_140k == (140000 // world >= 32768)
    assert forced is True


@pytest.mark.parametrize("name,world", [(n, w) for n in ("locate37", "count101", "fixed23")
                                        for w in WORLDS])
def test_sharded_equals_jax_sharded(setup, name, world):
    """Same blob, batch and shard count through the JAX package: equal
    counts, equal output layout (shard after shard), equal ``valid``,
    ``pids``, ``dropped``, and equal locations on the valid slots."""
    fm = setup["fm"]
    _, b, l = setup["batches"][name]
    kw = {}  # the answers do not depend on the engine; the JAX side gathers
    jsh = JaxShardedFmIndex(fm.to_device(), jax_make_mesh(n_devices=world))
    counts, (locs, pids, valid, dropped), (lo, hi) = setup["results"][world][0][name]["calls"]
    np.testing.assert_array_equal(counts, np.asarray(jsh.count(b, l, **kw)))
    jlo, jhi = jsh.pos_ranges(b, l, **kw)
    np.testing.assert_array_equal(lo, np.asarray(jlo))
    np.testing.assert_array_equal(hi, np.asarray(jhi))
    jl, jp, jv, jd = (np.asarray(x) for x in jsh.locate(b, l, **kw))
    assert locs.shape == jl.shape
    np.testing.assert_array_equal(valid, jv)
    np.testing.assert_array_equal(pids[valid], jp[jv])
    np.testing.assert_array_equal(locs[valid], jl[jv])
    np.testing.assert_array_equal(dropped, jd)


@pytest.mark.parametrize("world", WORLDS)
def test_explicit_capacity_drops_like_jax(setup, world):
    fm = setup["fm"]
    _, b, l = setup["batches"]["locate37"]
    locs, pids, valid, dropped = setup["results"][world][0]["capacity"]["calls"][0]
    jsh = JaxShardedFmIndex(fm.to_device(), jax_make_mesh(n_devices=world))
    jl, jp, jv, jd = (np.asarray(x) for x in jsh.locate(b, l, capacity_per_shard=64))
    assert locs.shape == (world * 64,)
    assert dropped.sum() > 0  # 37 patterns of 2-8 symbols overflow 64 slots per shard
    np.testing.assert_array_equal(dropped, jd)
    np.testing.assert_array_equal(valid, jv)
    np.testing.assert_array_equal(pids[valid], jp[jv])
    np.testing.assert_array_equal(locs[valid], jl[jv])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_wide_index(setup, world):
    """``force_wide``: the u64-position engines per shard (int64 values for
    the JAX package's uint64), stream and gather, against the host oracle."""
    fm = setup["fm"]
    pats = setup["batches"]["locate37"][0]
    res = setup["results"][world][0]["wide"]
    assert res["info"]["wide"]
    want = [fm.count(p) for p in pats]
    for counts, (locs, pids, valid, dropped), (lo, hi) in (res["calls"][:3], res["calls"][3:]):
        assert counts.dtype == np.int64 and counts.tolist() == want
        assert (hi - lo).tolist() == want
        by = _by_pattern(locs, pids, valid)
        for i, p in enumerate(pats):
            assert sorted(by.get(i, [])) == sorted(int(x) for x in fm.locate(p))


def test_sharded_wide_equals_jax_sharded(setup):
    fm = setup["fm"]
    _, b, l = setup["batches"]["locate37"]
    jsh = JaxShardedFmIndex(JaxDeviceFmIndex.from_host(fm, force_wide=True),
                            jax_make_mesh(n_devices=2))
    counts, (locs, pids, valid, dropped), _ = setup["results"][2][0]["wide"]["calls"][:3]
    np.testing.assert_array_equal(
        counts, np.asarray(jsh.count(b, l, use_stream=False)).astype(np.int64))
    jl, jp, jv, jd = jsh.locate(b, l, use_stream=False)
    assert locs.shape == np.asarray(jl).shape
    np.testing.assert_array_equal(valid, jv)
    np.testing.assert_array_equal(pids[valid], np.asarray(jp)[jv])
    np.testing.assert_array_equal(locs[valid], np.asarray(jl).astype(np.int64)[jv])
    np.testing.assert_array_equal(dropped, np.asarray(jd))


def test_failing_rank_fails_the_run(setup):
    """A rank that raises takes the run down with it: its peer, left in a
    collective, fails or is killed, well inside the deadline; nothing hangs
    and nothing is passed over."""
    job = dict(setup["job"], fail_rank=1, cases=setup["job"]["cases"][:1])
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 exited with code"):
        harness.run_ranks(2, job, setup["root"] / "failing")
    assert time.monotonic() - t0 < harness.JOIN_TIMEOUT
