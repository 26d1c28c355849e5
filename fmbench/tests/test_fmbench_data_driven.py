"""A configuration, a traffic mix and a per-layer metric added as new files
and entries, in a copy of the benchmark, are found and run with no edit to
any file the harness has."""
import json
import os
import shutil

from conftest import ROOT, run_cli

CONFIG = {
    "name": "wild5-mini",
    "source": "test only",
    "text_size": 400000,
    "reduced": [],
    "text": {"symbols": "ACGT", "runs": {"byte": "N", "share": 0.01, "mean_len": 200}},
    "encoding": {"symbols": ["A", "C", "G", "T"], "wildcard": True},
    "position": "u32", "block": "BLOCK3_U64", "sa_sampling": 2, "kmer_size": 3,
    "upload": {"dense_lut_entries": 65536, "dense_host_entries": 4096,
               "sa_full": "device", "sa_fill_ratio": 4},
    "control_prefix": 6,
}
MIX = {"op": "locate", "batch": 1500, "lengths": [12, 21], "pool": 3,
       "distinct_starts": False, "to_host": True}
METRIC = '''"""Calls in the window."""


def read(run):
    return float(len(run.latencies))
'''


def test_new_files_are_found_and_run(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "fmbench"), root / "fmbench",
                    ignore=shutil.ignore_patterns("runs", "__pycache__"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    (root / "fmbench" / "configs" / "wild5-mini.json").write_text(json.dumps(CONFIG))
    (root / "fmbench" / "traffic" / "mixed-small.json").write_text(json.dumps(MIX))
    (root / "fmbench" / "metrics" / "calls.window.py").write_text(METRIC)
    bench["configs"].append({"name": "wild5-mini", "source": "test only",
                             "file": "fmbench/configs/wild5-mini.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "wild5-mini.mixed", "config": "wild5-mini",
                               "traffic": "mixed-small", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "locate_qps":
            m["workloads"].append("wild5-mini.mixed")
    bench["per_layer"].append({"name": "calls.window", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "query API",
                               "moves": "locate_qps", "workloads": ["wild5-mini.mixed"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    env = {"PYTHONPATH": ROOT}
    args = ["--workload", "wild5-mini.mixed", "--seed", "77", "--seconds", "0.3", "--device", "cpu"]
    for trace, want in (("0", {"locate_qps", "setup_s"}), ("1", {"calls.window"})):
        code, out, err = run_cli(args + ["--trace", trace], env=env, cwd=str(root),
                                 script=str(root / "fmbench" / "run.py"))
        assert code == 0, err[-3000:]
        res = json.loads(out.strip().splitlines()[-1])
        assert res["correct"] is True, res["checks"]
        assert want <= set(res["metrics"]), res["metrics"]
    # the traced window is two cycles of the pool: 6 calls
    assert res["metrics"]["calls.window"]["value"] == 6.0
    # the text held the wildcard's runs, and the reference and the program agreed on them
    assert (root / "fmbench" / "runs").is_dir()


def test_a_directory_without_the_program_gives_no_result(tmp_path):
    """Only ``BENCHMARK.json`` and the benchmark's files: no result."""
    root = tmp_path / "bare"
    shutil.copytree(os.path.join(ROOT, "fmbench"), root / "fmbench",
                    ignore=shutil.ignore_patterns("runs", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    env = {"PYTHONPATH": ""}
    code, out, _ = run_cli(["--workload", "dna20-1e8.count-1m", "--seed", "1", "--seconds", "1",
                            "--trace", "0", "--device", "cpu", "--text-size", "100000"],
                           env=env, cwd=str(root), script=str(root / "fmbench" / "run.py"))
    assert code != 0 and out.strip() == ""
