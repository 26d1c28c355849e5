"""``tools/torch_scaling_report.py`` on the CPU at 1e5 bp, and its
communication model held to the code.

- The report: weak-scaling rows at 1 and 2 gloo ranks with the batch
  growing with the ranks and ``virtual: true``, the one-rank overhead, the
  model beside a measured two-process collective; it imports neither ``jax``
  nor ``sview_fmindex_tpu``.
- The model's bytes (``comm_bytes``) against a two-rank run of the parallel
  layer (``torch_dist_harness``): the range-sharded count's ``all_reduce``
  bytes as ``range_shard.STATS`` counts them, and the pattern-parallel
  gathers as the sizes of the gathered tensors.
"""
import importlib.util
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import sview_fmindex_tpu_torch as ft  # noqa: E402
from sview_fmindex_tpu_torch.ops.search import batch_facts  # noqa: E402

import torch_dist_harness as harness  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "torch_scaling_report.py")
PER_RANK, MODEL_B = 400, 1500


def _tool():
    spec = importlib.util.spec_from_file_location("torch_scaling_report", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    """One report in a fresh process that also says which modules it loaded."""
    d = tmp_path_factory.mktemp("scaling_report")
    argv = ["--device", "cpu", "--text-size", "1e5", "--per-rank", str(PER_RANK),
            "--ranks", "1,2", "--model-batch", str(MODEL_B), "--out", str(d / "r.json")]
    code = ("import importlib.util, json, sys\n"
            f"spec = importlib.util.spec_from_file_location('t', {TOOL!r})\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
            f"mod.main({argv!r})\n"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'sview_fmindex_tpu'))))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=400, cwd=str(d), env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    with open(d / "r.json") as f:
        written = json.load(f)
    assert json.loads(lines[-2]) == written
    return written, json.loads(lines[-1])


def test_weak_scaling_rows(report):
    rep, _ = report
    assert rep["virtual"] is True and rep["platform"] == "cpu" and rep["smi"] is None
    assert rep["host_cores"] == os.cpu_count() and "host contention" in rep["virtual_note"]
    rows = rep["weak_scaling"]
    assert [r["devices"] for r in rows] == [1, 2]
    assert [r["batch"] for r in rows] == [PER_RANK, 2 * PER_RANK]
    assert rows[0]["efficiency"] == 1.0
    for r in rows:
        assert r["count_qps"] > 0
        assert r["efficiency"] == pytest.approx(r["speedup"] / r["devices"], abs=0.006)


def test_model_and_measured_collective(report):
    rep, _ = report
    m, one, floor = rep["comm_model"], rep["one_rank"], rep["measured_collective"]
    assert m["ranks"] == 2 and m["batch"] == MODEL_B
    assert m["dp_count_gather_bytes"] == MODEL_B * 8
    assert m["rs_count_steps"] == one["steps"] > 0
    # at one rank the model's range-shard bytes are what the code counted
    assert one["rs_stats"]["all_reduce_bytes"] == 2 * MODEL_B * one["fused_width"] * 4 * one[
        "steps"]
    assert m["measured_compute_s_per_batch"] == one["locate_s"] > 0
    assert floor["gather_s"] > 0 and floor["all_reduce_s"] > 0
    assert floor["gather_int64_per_rank"] == 3 * m["capacity_per_shard"] + 1
    for k in ("dp_locate_efficiency_nvlink", "rs_count_efficiency_pcie_gen5",
              "dp_locate_efficiency_floor_gloo", "rs_step_efficiency_floor_gloo"):
        assert 0 < m[k] <= 1
    assert m["links_bytes_per_s"] == {"nvlink": 900e9, "pcie_gen5": 128e9}
    assert rep["shard_overhead_rank1"]["plain_s"] > 0


def test_imports_neither_jax_nor_the_jax_package(report):
    assert report[1] == []


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """A 2-rank run of both sharded classes over one blob: count and locate
    through ``ShardedFmIndex``, count through ``RangeShardedFmIndex``."""
    d = tmp_path_factory.mktemp("model_bytes")
    rng = np.random.default_rng(4)
    n = 40_000
    text = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]
    enc = ft.EncodingTable.from_symbols([b"A", b"C", b"G", b"T"])
    b = ft.FmIndexBuilder(n, 4, enc, position="u32", block=ft.BLOCK3_U64,
                          suffix_array_config=ft.SuffixArrayConfig.compressed(2),
                          lookup_table_config=ft.LookupTableConfig.kmer_size(3))
    (d / "index.blob").write_bytes(bytes(b.build(text.tobytes())))
    starts = rng.integers(0, n - 20, 300)
    pats = np.ascontiguousarray(text[starts[:, None] + np.arange(20)])
    lens = np.full(300, 20, np.int32)
    calls = [("count", (pats, lens), {}), ("locate", (pats, lens), {})]
    job = {"blob": str(d / "index.blob"), "load": {"block": (3, 64), "encoder_kind": "table"},
           "cases": [{"name": "dp", "kind": "sharded", "mesh": {"axis": "dp"},
                      "init": {"upload": {"dense_lut_entries": 0}}, "calls": calls},
                     {"name": "rs", "kind": "range", "mesh": {"axis": "rs"},
                      "calls": calls[:1]}]}
    return harness.run_ranks(2, job, d / "world"), lens


def test_model_bytes_equal_the_codes_on_two_ranks(two_ranks):
    ranks, lens = two_ranks
    comm_bytes = _tool().comm_bytes
    for rank in ranks:
        rs = rank["rs"]
        info = rs["info"]
        meta = types.SimpleNamespace(kmer_size=info["kmer_size"], dense_k=info["dense_k"])
        steps = batch_facts(meta, lens, len(lens), 20)[0]
        model = comm_bytes(len(lens), 2, 0, steps, info["fused_width"])
        assert rs["stats"][0]["all_reduce_calls"] == steps
        assert rs["stats"][0]["all_reduce_bytes"] == model["rs_count_all_reduce_bytes"]
        counts, (locs, pids, valid, dropped) = rank["dp"]["calls"]
        cap = locs.shape[0] // 2
        model = comm_bytes(len(lens), 2, cap, steps, info["fused_width"])
        # every gathered value travels as int64
        assert counts.size * 8 == model["dp_count_gather_bytes"]
        assert (counts.size + locs.size + pids.size + valid.size + dropped.size) * 8 == model[
            "dp_locate_gather_bytes"]
        assert rank["dp"]["stats"] == [{"all_reduce_calls": 0, "all_reduce_bytes": 0,
                                        "all_reduce_seconds": 0}] * 2
