"""The port's microbenchmark suite (``sview_fmindex_tpu_torch/bench/micro.py``)
on the CPU at a small size, against the JAX package's suite and device index.

- every group's rows are there, with the JAX rows' keys, units and batch
  sizes; the ``search`` and ``locate`` row names equal the ones the JAX suite
  prints at the same size (it runs here on the CPU backend, its kernel in
  interpret mode, one batch size and one repetition to keep it short);
- values are finite and positive;
- the ANSWERS computed inside the groups, not their times, are compared: the
  counts and ranges both engines return equal the JAX device index's on the
  same patterns, exactly; so do the located positions per pattern; the two
  rank engines agree with each other.
"""
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from sview_fmindex_tpu.bench import micro as jmicro  # noqa: E402
from sview_fmindex_tpu_torch.bench import micro as tmicro  # noqa: E402

TEXT, SEED, BATCHES = 100_000, 42, (512, 2048)


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    out = tmp_path_factory.mktemp("micro") / "rows.json"
    rep = tmicro.main(["--device", "cpu", "--text-size", "1e5", "--batches", "512,2048",
                       "--reps", "2", "--out", str(out)], keep_answers=True)
    rep["out_path"] = out
    return rep


@pytest.fixture(scope="module")
def jax_rows(tmp_path_factory):
    out = tmp_path_factory.mktemp("jmicro") / "rows.json"
    jmicro.main(["--cpu", "--text-size", "1e5", "--batches", "512", "--reps", "1",
                 "--groups", "search,locate", "--out", str(out)])
    with open(out) as f:
        return json.load(f)["rows"]


@pytest.fixture(scope="module")
def jax_index():
    """The JAX suite's own index and upload at the same size and seed."""
    text, fm, sa_full, _ = jmicro.build_index(TEXT, SEED, None)
    return text, fm, fm.to_device(dense_lut_entries=1 << 16, dense_host_entries=1 << 20)


def _names(rows, group, B):
    return [r["name"] for r in rows if r["group"] == group and r["B"] == B]


@pytest.mark.parametrize("group,names", [
    ("rank", ["gather", "stream", "join_only"]),
    ("sort", ["sort_i64_perm", "sort_i64_only"]),
    ("search", ["count[gather]", "count[stream]"]),
])
def test_group_rows_present(report, group, names):
    for B in BATCHES:
        assert _names(report["rows"], group, B) == names


def test_locate_rows_present(report):
    for B in BATCHES:
        names = [re.sub(r"cap=\d+", "cap", n) for n in _names(report["rows"], "locate", B)]
        assert names == ["ranges[gather]", "ranges[stream]", "resolve[cap]",
                         "locate[gather,cap]", "locate[stream,cap]"]


def test_build_rows_present(report):
    names = _names(report["rows"], "build", TEXT)
    assert names[:2] == ["host_build", "device_upload"]
    assert {"upload[put]", "upload[stream]", "upload[pair]", "upload[sa_fill]"} <= set(names)


@pytest.mark.parametrize("group", ["search", "locate"])
def test_row_names_units_and_batches_equal_the_jax_suite(report, jax_rows, group):
    ours = [(r["name"], r["unit"], r["B"]) for r in report["rows"]
            if r["group"] == group and r["B"] == 512]
    theirs = [(r["name"], r["unit"], r["B"]) for r in jax_rows if r["group"] == group]
    assert ours == theirs and ours
    keys = {"group", "name", "B", "value", "unit", "steady_ms", "warm_s"}
    assert all(set(r) == keys for r in report["rows"] if r["group"] == group)
    assert all(set(r) == keys for r in jax_rows if r["group"] == group)


def test_values_finite_and_positive(report):
    for r in report["rows"]:
        assert np.isfinite(r["value"]), r
        if r["group"] == "build":
            assert r["value"] >= 0 and r["unit"] == "s"
        else:
            assert r["value"] > 0 and r["unit"] == "ns/q" and r["steady_ms"] > 0, r


def test_out_file_and_last_line(report, capsys):
    with open(report["out_path"]) as f:
        written = json.load(f)
    assert written["rows"] == report["rows"] and written["device"] == "cpu"
    assert written["text_size"] == TEXT and "answers" not in written
    # no join kernel is launched for CPU tensors
    assert written["launches"] == {"rank": 0, "search": 0, "locate": 0}
    tmicro.main(["--device", "cpu", "--text-size", "2e4", "--batches", "64", "--reps", "1",
                 "--groups", "sort"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        "metric": "micro_rows", "value": 2, "unit": "rows"}


@pytest.mark.parametrize("B", BATCHES)
def test_answers_inside_the_groups_equal_the_jax_device_index(report, jax_index, B):
    text, fm, jdev = jax_index
    ans = report["answers"][B]
    pats = np.asarray(jmicro.make_patterns(text, B, 20, SEED + 1))
    np.testing.assert_array_equal(ans["patterns"], pats)
    lens = np.full(B, 20, np.int32)
    jcounts = np.asarray(jdev.count(pats, lens)).astype(np.int64)
    jlo, jhi = (np.asarray(a).astype(np.int64) for a in jdev.pos_ranges(pats, lens))
    assert (jcounts >= 1).all()
    for eng in ("gather", "stream"):
        np.testing.assert_array_equal(ans[f"count[{eng}]"], jcounts)
        lo, hi = ans[f"ranges[{eng}]"]
        np.testing.assert_array_equal(lo, jlo)
        np.testing.assert_array_equal(hi, jhi)
        locs, pids, valid, counts, dropped = ans[f"locate[{eng}]"]
        assert int(dropped[0]) == 0
        np.testing.assert_array_equal(counts, jcounts)
        jl, jp, jv, _ = (np.asarray(a) for a in jdev.locate(pats, lens, capacity=locs.shape[0]))
        np.testing.assert_array_equal(valid, jv)
        np.testing.assert_array_equal(locs[jv], jl[jv].astype(np.int64))
        np.testing.assert_array_equal(pids[jv], jp[jv].astype(np.int64))
    np.testing.assert_array_equal(ans["rank[gather]"], ans["rank[stream]"])


def test_rank_group_fails_when_an_engine_disagrees(monkeypatch):
    """The ``rank`` group holds its rows' answers against each other once per
    B, outside the timed loops: a stream engine that is off by one fails the
    run."""
    from sview_fmindex_tpu_torch.ops import stream_join

    real = stream_join.rank_next_sorted
    monkeypatch.setattr(stream_join, "rank_next_sorted", lambda *a, **k: real(*a, **k) + 1)
    with pytest.raises(RuntimeError, match="rank group, B=64: .* do not agree"):
        tmicro.main(["--device", "cpu", "--text-size", "2e4", "--batches", "64", "--reps", "1",
                     "--groups", "rank"])


def test_rank_group_fails_when_the_join_is_wrong(monkeypatch):
    """A join whose rank mode is off by one (the upload's decode mode left
    alone) differs from the gather engine and from ``join_plain``."""
    from sview_fmindex_tpu_torch.ops import stream_join

    real = stream_join.join

    def off(table, key, payload, sigma, decode, *a, **k):
        rank, sym = real(table, key, payload, sigma, decode, *a, **k)
        return (rank if decode else rank + 1), sym

    monkeypatch.setattr(stream_join, "join", off)
    with pytest.raises(RuntimeError, match="do not agree"):
        tmicro.main(["--device", "cpu", "--text-size", "2e4", "--batches", "64", "--reps", "1",
                     "--groups", "rank"])


def test_crossover_table_reads_the_search_rows(report):
    lines = tmicro.crossover_table(report["rows"])
    assert len(lines) == 1 + len(BATCHES)
    assert all(re.search(r"(stream|gather) x\d+\.\d\d$", ln) for ln in lines[1:])


def test_raises_without_a_card_unless_the_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmicro.main(["--text-size", "2e4", "--batches", "64"])


def test_cache_dir_reads_the_headline_blob(tmp_path):
    """At seed 42 the suite reads the headline bench's cached blob, byte for
    byte what it would build itself."""
    _, fm, build_s, path = tmicro.build_index(20_000, 42, str(tmp_path))
    assert build_s > 0 and path.endswith("micro_20000_42.blob")
    blob = open(path, "rb").read()
    other = tmp_path / "other"
    other.mkdir()
    (other / "index_20000_42_b3u64_r2_k3.blob").write_bytes(blob)
    _, fm2, build_s2, path2 = tmicro.build_index(20_000, 42, str(other))
    assert build_s2 == 0.0 and path2.endswith("index_20000_42_b3u64_r2_k3.blob")
    assert fm2.text_len == fm.text_len == 20_000
