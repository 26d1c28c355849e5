"""``bench_torch.py``, the headline bench on the port, run on the CPU at a
small size (``BENCH_TEXT_SIZE=2e5``, batches of 1000 and 4000).

Its one JSON line has every key of ``bench.py``'s but ``prewarm_s`` plus the
port's own (worst windows, both clocks, upload phases, the device); ``hits``
and ``capacity`` per batch equal what the JAX device index gives for the same
seeded batches over the same cached blob; the text and blob files carry
``bench.py``'s names and bytes; a corrupted SA entry fails the run at the
raw-text re-check.
"""
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import sview_fmindex_tpu as fmx  # noqa: E402
from sview_fmindex_tpu.ops.locate import expand_capacity as jax_expand_capacity  # noqa: E402

import bench_torch  # noqa: E402

TEXT, SMALL, BIG = 200_000, 1000, 4000
# bench.py:245-258 without prewarm_s
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "count_qps", "headline_batch",
              "text_size", "batches", "build_s", "upload_s", "first_query_s"}
BATCH_KEYS = {"warmup_s", "count_qps", "locate_qps", "hits", "capacity"}


def _setenv(mp, cache):
    mp.setenv("BENCH_TEXT_SIZE", "2e5")
    mp.setenv("BENCH_PATTERN_COUNT", str(SMALL))
    mp.setenv("BENCH_BIG_BATCH", str(BIG))
    mp.setenv("BENCH_CACHE_DIR", str(cache))


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return tmp_path_factory.mktemp("bench_main_cache")


@pytest.fixture()
def env(monkeypatch, cache):
    _setenv(monkeypatch, cache)
    return cache


@pytest.fixture(scope="module")
def line(cache):
    """The bench's stdout of one run: ONE line; progress goes to stderr."""
    import contextlib
    import io

    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        _setenv(mp, cache)
        bench_torch.main(["--device", "cpu"])
    out = buf.getvalue().strip().splitlines()
    assert len(out) == 1
    return json.loads(out[0])


def test_json_line_has_every_key(line):
    assert BENCH_KEYS <= set(line) and "prewarm_s" not in line
    assert {"value_worst", "count_qps_worst", "upload_phases", "device"} <= set(line)
    assert line["metric"] == "locate_queries_per_sec_per_chip" and line["unit"] == "queries/s"
    assert line["text_size"] == TEXT and line["value"] > 0
    assert line["value_worst"] <= line["value"]
    assert line["vs_baseline"] == round(line["value"] / 2.3e5, 2)
    assert set(line["batches"]) == {str(SMALL), str(BIG)}
    assert line["headline_batch"] in (SMALL, BIG)
    assert line["value"] == line["batches"][str(line["headline_batch"])]["locate_qps"]
    assert line["device"] == {"platform": "cpu", "name": "cpu", "smi": None}
    assert {"put", "stream", "pair", "sa_fill"} <= set(line["upload_phases"])
    assert line["first_query_s"] > 0 and line["upload_s"] > 0
    for r in line["batches"].values():
        assert BATCH_KEYS <= set(r)
        for k in ("count_qps", "locate_qps"):
            assert 0 < r[f"{k}_worst"] <= r[k]
            # CUDA events exist only on a card
            assert r[f"{k}_events"] is None and r[f"{k}_events_worst"] is None


def test_launches_are_reported_and_empty_on_the_cpu(line):
    """The run's own join-kernel launch counts: over the upload and over one
    ``count`` and one ``locate_with_counts`` call per batch.  For CPU tensors
    the plain version serves and nothing is counted."""
    per_call = {"count": {}, "locate": {}}
    assert line["launches"] == {"upload": {}, str(SMALL): per_call, str(BIG): per_call}


def test_launches_since_reads_the_counters_by_mode_and_sigma(monkeypatch):
    from sview_fmindex_tpu_torch.ops import stream_join

    monkeypatch.setattr(stream_join, "LAUNCHES_BY_SIGMA", stream_join.LAUNCHES_BY_SIGMA.copy())
    stream_join.LAUNCHES_BY_SIGMA["decode", 4] += 5
    mark = bench_torch.launch_mark()
    assert bench_torch.launches_since(mark) == {}
    stream_join.LAUNCHES_BY_SIGMA["rank", 16] += 3
    stream_join.LAUNCHES_BY_SIGMA["decode", 4] += 1
    assert bench_torch.launches_since(mark) == {"decode@4": 1, "rank@16": 3}


def test_hits_and_capacity_equal_the_jax_device_index(line, env):
    """The same seeded batches over the same blob through the JAX package."""
    text = np.fromfile(env / f"text_{TEXT}_42.bin", np.uint8)
    rng = np.random.default_rng(42)
    np.testing.assert_array_equal(
        text, np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=TEXT)])
    blob = np.fromfile(env / f"index_{TEXT}_42_b3u64_r2_k3.blob", np.uint8)
    fm = fmx.FmIndex.load(blob, position="u32", block=fmx.BLOCK3_U64, encoder_kind="table")
    jdev = fm.to_device(dense_lut_entries=1 << 16)
    rng = np.random.default_rng(43)
    for B in (SMALL, BIG):
        starts = rng.integers(0, TEXT - 20, size=B)
        pats = text[starts[:, None] + np.arange(20)]
        counts = np.asarray(jdev.count(pats, np.full(B, 20, np.int32)))
        r = line["batches"][str(B)]
        assert r["hits"] == int(counts.sum()) >= B
        assert r["capacity"] == jax_expand_capacity(counts)


def test_cached_blob_is_the_jax_builders(line, env):
    """``bench.py``'s file names, and the bytes the JAX package's builder
    writes for the same text: the two benches share one cache."""
    text = np.fromfile(env / f"text_{TEXT}_42.bin", np.uint8)
    enc = fmx.EncodingTable.from_symbols([b"A", b"C", b"G", b"T"])
    b = fmx.FmIndexBuilder(TEXT, 4, enc, position="u32", block=fmx.BLOCK3_U64,
                           suffix_array_config=fmx.SuffixArrayConfig.compressed(2),
                           lookup_table_config=fmx.LookupTableConfig.kmer_size(3))
    assert bytes(b.build(text)) == (env / f"index_{TEXT}_42_b3u64_r2_k3.blob").read_bytes()
    assert line["build_s"] >= 0


def test_a_corrupted_sa_entry_fails_the_run(env, monkeypatch, capsys):
    """One wrong suffix-array entry under the first pattern: the raw-text
    re-check refuses it and nothing is printed."""
    real_upload = bench_torch.upload

    def corrupt(fm, device=None):
        dev = real_upload(fm, device)
        text = bench_torch.get_text(TEXT)
        pats = bench_torch.make_batch(text, np.random.default_rng(43), SMALL)
        lo, hi = dev.pos_ranges(pats[:1])
        assert int(hi[0] - lo[0]) >= 1
        dev.sa[int(lo[0])] += 3
        return dev

    monkeypatch.setattr(bench_torch, "upload", corrupt)
    with pytest.raises(RuntimeError, match="does not hold pattern 0"):
        bench_torch.main(["--device", "cpu"])
    assert capsys.readouterr().out == ""


def test_a_corrupted_pair_table_fails_the_parity_gate(env, monkeypatch, capsys):
    """A wrong word in the pair table changes the stream engine's answers
    only: a check fails the run before anything is printed."""
    real_upload = bench_torch.upload

    def corrupt(fm, device=None):
        dev = real_upload(fm, device)
        dev.pair_tbl[:, :16] += 1  # every checkpoint of every code
        return dev

    monkeypatch.setattr(bench_torch, "upload", corrupt)
    with pytest.raises(RuntimeError, match="bench check failed"):
        bench_torch.main(["--device", "cpu"])
    assert capsys.readouterr().out == ""


def test_raises_without_a_card_unless_the_cpu_is_named(env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.main([])
