"""A collection of near-identical genomes through the whole harness, in a
copy of the benchmark with one configuration, one cell and one metric added
as files and entries: the program locates every occurrence of patterns that
occur several times each, the run is correct, and the control is not."""
import json
import os
import shutil

from conftest import ROOT, run_cli

CONFIG = {
    "name": "coll8-mini",
    "source": "test only",
    "text_size": 400000,
    "reduced": [],
    "text": {"symbols": "ACGT", "collection": {"copies": 8, "substitution_rate": 0.01}},
    "encoding": {"symbols": ["A", "C", "G", "T"], "wildcard": False},
    "position": "u32", "block": "BLOCK3_U64", "sa_sampling": 2, "kmer_size": 3,
    "upload": {"dense_lut_entries": 65536, "dense_host_entries": 4096,
               "sa_full": "device", "sa_fill_ratio": 4},
    "control_prefix": 8,
}
MIX = {"op": "locate", "batch": 2000, "lengths": [20, 20], "pool": 3,
       "distinct_starts": True, "to_host": False}
# located positions per pattern, read by locating each batch of the pool on
# the live index after the traced window
METRIC = '''"""Located positions per pattern over the pool."""


def probe(run):
    rows = patterns = 0
    for pats, lens in run.pool:
        _, _, valid, _, _ = run.dev.locate_with_counts(pats, lens)
        rows += int(valid.sum())
        patterns += pats.shape[0]
    run.probes["located_per_pattern"] = rows / patterns


def read(run):
    return run.probes.get("located_per_pattern")
'''


def test_collection_cell_is_correct_and_its_control_is_not(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "fmbench"), root / "fmbench",
                    ignore=shutil.ignore_patterns("runs", "__pycache__"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    (root / "fmbench" / "configs" / "coll8-mini.json").write_text(json.dumps(CONFIG))
    (root / "fmbench" / "traffic" / "locate-small.json").write_text(json.dumps(MIX))
    (root / "fmbench" / "metrics" / "located.locate.py").write_text(METRIC)
    bench["configs"].append({"name": "coll8-mini", "source": "test only",
                             "file": "fmbench/configs/coll8-mini.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "coll8-mini.locate", "config": "coll8-mini",
                               "traffic": "locate-small", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "locate_qps":
            m["workloads"].append("coll8-mini.locate")
    bench["per_layer"].append({"name": "located.locate", "unit": "rows", "better": "higher",
                               "source": "program_counter", "layer": "resolve",
                               "moves": "locate_qps", "workloads": ["coll8-mini.locate"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code, out, err = run_cli(
        ["--workload", "coll8-mini.locate", "--seed", "20260101", "--seconds", "0.3",
         "--trace", "1", "--device", "cpu", "--control"],
        env={"PYTHONPATH": ROOT}, cwd=str(root), script=str(root / "fmbench" / "run.py"))
    assert code == 0, err[-3000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["control"]["correct"] is False, res["control"]
    # about 1 + 7 * 0.99^40 = 5.7 positions a pattern
    assert res["metrics"]["located.locate"]["value"] > 3, res["metrics"]
