"""``tools/torch_wide_scale_check.py`` on the CPU at 3e5 bp: a u64 blob and a
u32 one served range-sharded through ``force_wide=True`` over one gloo rank
in the process and two gloo rank processes (the process harness of
``bench/scaling.py``).  Its answers equal the host oracle's (the tool's own
check) and the JAX package's ``RangeShardedFmIndex`` on the same blob, batch
and rank count; the JSON has the JAX tool's keys; the tool imports neither
``jax`` nor ``sview_fmindex_tpu``; and without a card it runs only where the
CPU is named."""
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import sview_fmindex_tpu as fmx  # noqa: E402
from sview_fmindex_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from sview_fmindex_tpu.parallel.range_shard import (  # noqa: E402
    RangeShardedFmIndex as JaxRangeShardedFmIndex,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "torch_wide_scale_check.py")
TEXT = 300_000
PATTERNS = 64
# the keys tools/wide_scale_check.py writes
JAX_KEYS = ["text_len", "position", "devices", "backend", "patterns", "pattern_len",
            "locations_checked", "locations_above_2_32", "mismatches", "ok", "shard_s",
            "shard_rss_before_kb", "shard_rss_after_kb", "query_s", "oracle_s"]
CASES = [("u64", 1), ("u64", 2), ("u32", 2)]


def _tool():
    spec = importlib.util.spec_from_file_location("torch_wide_scale_check", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A seeded ACGT text (with a few repeats, so some patterns occur more
    than once) and its blob at u64 and at u32 positions."""
    d = tmp_path_factory.mktemp("wide_scale")
    rng = np.random.default_rng(9)
    text = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, TEXT)].copy()
    for a in rng.integers(0, TEXT - 500, 20):
        text[a + 250:a + 500] = text[a:a + 250]
    text.tofile(d / "text.bin")
    enc = fmx.EncodingTable.from_symbols([b"A", b"C", b"G", b"T"])
    for pos in ("u64", "u32"):
        b = fmx.FmIndexBuilder(TEXT, 4, enc, position=pos, block=fmx.BLOCK3_U64,
                               suffix_array_config=fmx.SuffixArrayConfig.compressed(2),
                               lookup_table_config=fmx.LookupTableConfig.kmer_size(3))
        (d / f"{pos}.blob").write_bytes(bytes(b.build(text.tobytes())))
    return d


@pytest.fixture(scope="module")
def reports(files):
    """One run of the tool per case: the one-rank u64 run in a fresh process
    that reports the modules it loaded, the two-rank runs in this one."""
    out = {}
    for pos, ranks in CASES:
        path = files / f"{pos}_{ranks}.json"
        argv = ["--text", str(files / "text.bin"), "--blob", str(files / f"{pos}.blob"),
                "--patterns", str(PATTERNS), "--device", "cpu", "--ranks", str(ranks),
                "--out", str(path)]
        if ranks == 1:
            code = ("import importlib.util, json, sys\n"
                    f"spec = importlib.util.spec_from_file_location('t', {TOOL!r})\n"
                    "mod = importlib.util.module_from_spec(spec)\n"
                    "spec.loader.exec_module(mod)\n"
                    f"mod.main({argv!r})\n"
                    "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
                    "('jax', 'sview_fmindex_tpu'))))\n")
            proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                                  timeout=300, cwd=str(files),
                                  env=dict(os.environ, PYTHONPATH=REPO))
            assert proc.returncode == 0, proc.stderr[-3000:]
            out["modules"] = json.loads(proc.stdout.strip().splitlines()[-1])
            out["printed"] = json.loads(proc.stdout.strip().splitlines()[-2])
        else:
            _tool().main(argv)
        with open(path) as f:
            out[pos, ranks] = json.load(f)
    return out


@pytest.mark.parametrize("pos,ranks", CASES)
def test_exact_against_the_host_oracle(reports, pos, ranks):
    rep = reports[pos, ranks]
    assert rep["ok"] and rep["mismatches"] == 0
    assert rep["text_len"] == TEXT and rep["position"] == pos and rep["devices"] == ranks
    assert rep["backend"] == "gloo" and rep["platform"] == "cpu" and rep["smi"] is None
    assert rep["locations_checked"] == sum(rep["answers"]["counts"]) >= PATTERNS
    assert rep["locations_above_2_32"] == 0  # the text is short: no requirement
    assert max(rep["answers"]["counts"]) > 1  # some patterns occur more than once


@pytest.mark.parametrize("pos,ranks", CASES)
def test_equal_to_the_jax_range_sharded_index(reports, files, pos, ranks):
    """The JAX package's RangeShardedFmIndex over the same blob, the same
    patterns and as many devices, wide, without dense seeds."""
    rep = reports[pos, ranks]
    text = np.fromfile(files / "text.bin", np.uint8)
    starts, pats = _tool().draw_patterns(text, PATTERNS, 20, 123)
    assert rep["answers"]["starts"] == starts.tolist()
    fm = fmx.FmIndex.load(np.fromfile(files / f"{pos}.blob", np.uint8), position=pos,
                          block=fmx.BLOCK3_U64, encoder_kind="table")
    jrs = JaxRangeShardedFmIndex(fm, mesh=jax_make_mesh(n_devices=ranks, axis="rs"),
                                 force_wide=True, dense_entries=0)
    lens = np.full(PATTERNS, 20, np.int32)
    from sview_fmindex_tpu.ops.wide import combine64

    counts = np.asarray(jrs.count(pats, lens))
    counts = combine64(*counts) if counts.ndim == 2 else counts
    assert np.asarray(counts).astype(np.int64).tolist() == rep["answers"]["counts"]
    locs, pids, valid, dropped = jrs.locate(pats, lens)
    locs = np.asarray(locs)
    locs = combine64(*locs) if locs.ndim == 2 else locs
    by = [[] for _ in range(PATTERNS)]
    for loc, p, v in zip(np.asarray(locs).astype(np.int64), np.asarray(pids),
                         np.asarray(valid)):
        if v:
            by[int(p)].append(int(loc))
    assert [sorted(b) for b in by] == rep["answers"]["locations"]


def test_json_keys_and_printed_line(reports):
    rep = reports["u64", 2]
    assert list(rep)[:2] == JAX_KEYS[:2] and set(JAX_KEYS) <= set(rep)
    assert [r["rank"] for r in rep["ranks"]] == [0, 1]
    for r in rep["ranks"]:
        # the one call timed with its collectives: both ranks reduce alike
        assert r["all_reduce_calls"] > 0 and 0 < r["all_reduce_share"] <= 1
        assert r["all_reduce_bytes"] == rep["ranks"][0]["all_reduce_bytes"]
        assert r["sa_entries"] == -(-(TEXT // 2) // 2)  # r=2 sampled SA over 2 ranks
    printed = reports["printed"]
    assert "answers" not in printed and printed["ok"] and set(JAX_KEYS) <= set(printed)


def test_imports_neither_jax_nor_the_jax_package(reports):
    assert reports["modules"] == []


def test_raises_without_a_card_unless_the_cpu_is_named(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _tool().run(str(files / "text.bin"), str(files / "u64.blob"), 8)
