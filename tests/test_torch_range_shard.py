"""Range-sharded serving of the port (``parallel/range_shard.py``) on gloo
ranks on the CPU, case for case with ``tests/test_range_shard.py``: the
fused and SA tables split by block range over ``rs`` in 2 and 4, with the
sampled SA (the collective LF walk) and the full SA (one collective gather),
the ``(rs, dp) = (2, 2)`` mesh, and ``force_wide`` (u64 positions).

Each world size is started once per module (``torch_dist_harness``); the
cases read its results.  Exact throughout: counts and location sets equal
the host oracle's, every rank returns the same arrays, a rank holds
``ceil(n_blocks / D)`` fused rows and ``ceil(n_sa / D)`` SA entries and no
more, and the arrays equal the JAX package's ``RangeShardedFmIndex`` on the
same blob, batch and mesh shape.
"""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from sview_fmindex_tpu import (  # noqa: E402
    BlockKind,
    EncodingTable,
    FmIndex,
    FmIndexBuilder,
    LookupTableConfig,
    SuffixArrayConfig,
)
from sview_fmindex_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from sview_fmindex_tpu.parallel.range_shard import (  # noqa: E402
    RangeShardedFmIndex as JaxRangeShardedFmIndex,
)
from sview_fmindex_tpu.utils.patterns import pack_patterns  # noqa: E402

import torch_dist_harness as harness  # noqa: E402
from oracle import gen_rand_pattern, gen_rand_symbols, gen_rand_text  # noqa: E402

RS, RS_DP = {"axis": "rs"}, {"shape": (2, 2), "axes": ("rs", "dp")}
# (case name, world, mesh, constructor keywords)
LAYOUTS = [
    ("rs1_walk", 1, RS, {}),
    ("rs2_walk", 2, RS, {}),
    ("rs2_full", 2, RS, {"sa_full": True}),
    ("rs2_wide", 2, RS, {"force_wide": True}),
    ("rs2_nodense", 2, RS, {"dense_entries": 0}),
    ("rs4_walk", 4, RS, {}),
    ("rs4_full", 4, RS, {"sa_full": True}),
    ("rs4_wide", 4, RS, {"force_wide": True}),
    ("rs2dp2_walk", 4, RS_DP, {"dp_axis": "dp"}),
    ("rs2dp2_full", 4, RS_DP, {"dp_axis": "dp", "sa_full": True}),
    ("rs2dp2_wide", 4, RS_DP, {"dp_axis": "dp", "force_wide": True}),
]
LAYOUT_IDS = [c[0] for c in LAYOUTS]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The index of tests/test_range_shard.py (5 symbols, r=2, k=2, its full
    SA beside it), one batch with an absent pattern (21 lanes: padded on the
    dp axis), and every world's results."""
    root = tmp_path_factory.mktemp("rs")
    rng = random.Random(3)
    symbols = gen_rand_symbols(rng, 5)
    text = gen_rand_text(rng, symbols, 3000, 3500)
    enc = EncodingTable.from_symbols(symbols)
    sa_path = str(root / "sa_full.u32")
    builder = FmIndexBuilder(
        len(text), enc.symbol_count(), enc, block=BlockKind(3, 64),
        suffix_array_config=SuffixArrayConfig.compressed(2),
        lookup_table_config=LookupTableConfig.kmer_size(2))
    blob = bytes(builder.build(text, sa_full_path=sa_path))
    fm = FmIndex.load(np.frombuffer(blob, np.uint8), block=BlockKind(3, 64),
                      encoder_kind="table")
    blob_path = str(root / "index.blob")
    with open(blob_path, "wb") as f:
        f.write(blob)
    pats = [gen_rand_pattern(rng, text, 1, 10) for _ in range(20)]
    pats.append(b"\x00\x01zzqq")  # absent pattern -> empty range lanes
    batch, lens = pack_patterns(pats)
    calls = [("count", (batch, lens), {}), ("locate", (batch, lens), {}),
             ("pos_ranges", (batch, lens), {}), ("locate", (batch, lens), {"capacity": 40})]
    results = {}
    for world in (1, 2, 4):
        cases = []
        for name, w, mesh, init in LAYOUTS:
            if w == world:
                init = dict(init)
                if init.get("sa_full"):
                    init["sa_full"] = sa_path
                cases.append({"name": name, "kind": "range", "mesh": mesh, "init": init,
                              "calls": calls})
        job = {"blob": blob_path, "load": {"block": (3, 64), "encoder_kind": "table"},
               "cases": cases}
        results[world] = harness.run_ranks(world, job, root / f"world{world}")
    return {"fm": fm, "pats": pats, "batch": batch, "lens": lens, "sa_path": sa_path,
            "results": results}


def _by_pattern(locs, pids, valid):
    by = {}
    for l, p, v in zip(locs, pids, valid):
        if v:
            by.setdefault(int(p), []).append(int(l))
    return by


@pytest.mark.parametrize("name,world,mesh,init", LAYOUTS, ids=LAYOUT_IDS)
def test_range_sharded_matches_host(setup, name, world, mesh, init):
    fm, pats = setup["fm"], setup["pats"]
    res = setup["results"][world][0][name]
    assert res["info"]["has_sa_full"] == bool(init.get("sa_full"))
    counts, (locs, pids, valid, dropped), (lo, hi), _ = res["calls"]
    want = [fm.count(p) for p in pats]
    assert counts.dtype == np.int64 and counts.tolist() == want
    assert (hi - lo).tolist() == want
    by = _by_pattern(locs, pids, valid)
    for i, p in enumerate(pats):
        assert sorted(by.get(i, [])) == sorted(int(x) for x in fm.locate(p)), (i, p)
    assert dropped.shape == (res["info"]["dp_size"],)


@pytest.mark.parametrize("name,world,mesh,init", LAYOUTS, ids=LAYOUT_IDS)
def test_a_rank_holds_its_block_range_and_no_more(setup, name, world, mesh, init):
    """The point of range sharding: every rank stages ceil(n / D) rows of
    the fused table and of the SA (sampled or full), not the tables."""
    D = 2 if "dp_axis" in init else world
    for rank in setup["results"][world]:
        info = rank[name]["info"]
        n_sa = info["text_len"] if init.get("sa_full") else info["n_sa"]
        assert info["fused_rows"] == -(-info["n_blocks"] // D)
        assert info["sa_len"] == -(-n_sa // D)
        assert info["dp_size"] == (2 if "dp_axis" in init else 1)
        # wide: one int64 column; narrow: uint32 words
        assert info["sa_dtype"] == ("torch.int64" if init.get("force_wide") else "torch.int32")


@pytest.mark.parametrize("world", (2, 4))
def test_every_rank_returns_the_same(setup, world):
    ranks = setup["results"][world]
    assert len(ranks) == world
    for other in ranks[1:]:
        for name, res in ranks[0].items():
            for a, b in zip(res["calls"], other[name]["calls"]):
                for x, y in zip(a if isinstance(a, tuple) else (a,),
                                b if isinstance(b, tuple) else (b,)):
                    np.testing.assert_array_equal(x, y)


def test_layouts_agree(setup):
    """One merged answer over every layout: rs in 1, 2, 4, the 2-D mesh,
    walk or full SA, narrow or wide."""
    merged = []
    for name, world, _, _ in LAYOUTS:
        counts, (locs, pids, valid, _), _, _ = setup["results"][world][0][name]["calls"]
        merged.append((counts.tolist(),
                       sorted((int(p), int(l)) for l, p, v in zip(locs, pids, valid) if v)))
    assert all(m == merged[0] for m in merged[1:])


def _jax_index(setup, world, mesh, init):
    fm = setup["fm"]
    kw = {k: v for k, v in init.items() if k != "sa_full"}
    if init.get("sa_full"):
        kw["sa_full"] = setup["sa_path"]
    if "shape" in mesh:
        devs = np.array(jax.devices()[:4]).reshape(2, 2)
        return JaxRangeShardedFmIndex(fm, mesh=Mesh(devs, ("rs", "dp")), axis="rs", **kw)
    return JaxRangeShardedFmIndex(fm, mesh=jax_make_mesh(n_devices=world, axis="rs"), **kw)


def _u64(x):
    return np.asarray(x).astype(np.int64)


JAX_HELD = ("rs2_walk", "rs2_wide", "rs4_full", "rs2dp2_walk", "rs2dp2_full", "rs2dp2_wide")


@pytest.mark.parametrize("name,world,mesh,init", [c for c in LAYOUTS if c[0] in JAX_HELD],
                         ids=JAX_HELD)
def test_range_sharded_equals_jax_range_sharded(setup, name, world, mesh, init):
    """Same blob, batch and mesh shape through the JAX package: equal
    counts and ranges, equal output layout, ``valid``, ``pids`` and
    ``dropped``, equal locations on the valid slots; auto-sized and with an
    explicit capacity that overflows."""
    batch, lens = setup["batch"], setup["lens"]
    jrs = _jax_index(setup, world, mesh, init)
    counts, auto, (lo, hi), capped = setup["results"][world][0][name]["calls"]
    np.testing.assert_array_equal(counts, _u64(jrs.count(batch, lens)))
    jr = jrs.pos_ranges(batch, lens)
    if init.get("force_wide"):
        from sview_fmindex_tpu.ops.wide import combine64

        jlo, jhi = combine64(*jr[:2]), combine64(*jr[2:])
    else:
        jlo, jhi = jr
    np.testing.assert_array_equal(lo, _u64(jlo))
    np.testing.assert_array_equal(hi, _u64(jhi))
    for (locs, pids, valid, dropped), cap in ((auto, None), (capped, 40)):
        jl, jp, jv, jd = (np.asarray(x) for x in jrs.locate(batch, lens, capacity=cap))
        assert locs.shape == jl.shape
        np.testing.assert_array_equal(valid, jv)
        np.testing.assert_array_equal(pids[valid], jp[jv])
        np.testing.assert_array_equal(locs[valid], _u64(jl)[jv])
        np.testing.assert_array_equal(dropped, _u64(jd).reshape(-1))
    assert capped[3].sum() > 0  # 40 slots overflow
