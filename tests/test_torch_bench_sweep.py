"""``run_benchmark_torch.py``, the benchmark sweep on the port, on the CPU.

- ``gen_patterns`` equals ``run_benchmark.gen_patterns`` (the JAX-side
  script, imported here only) for the same text file and seed;
- a sweep of one pattern count x one cold ratio x {memory, mmap} writes the
  CSV header and two rows; the locations written equal the port's host
  ``FmIndex`` answers, and the ``mmap`` file equals, byte for byte, the one
  the JAX-side script's ``--cell`` writes for the same inputs;
- a cell made to fail makes the sweep exit non-zero after the CSV is written;
- ``device`` and ``device-warm`` cells (``--device cpu``), ``--serve-grid``
  and ``--merge-into``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import run_benchmark  # noqa: E402  (the JAX-side script: numpy only at import)
import run_benchmark_torch as rbt  # noqa: E402
import sview_fmindex_tpu_torch as ft  # noqa: E402

TEXT, COUNT, COLD = 200_000, 40, 0.25
HEADER = "pattern_count,cold_ratio,algorithm,total_ns,load_percent,max_rss_kb"


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    d = tmp_path_factory.mktemp("sweep_cache")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BENCH_CACHE_DIR", str(d))
        rbt.ensure_inputs(TEXT)
    return d


@pytest.fixture()
def env(monkeypatch, cache):
    monkeypatch.setenv("BENCH_CACHE_DIR", str(cache))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(run_benchmark, "CACHE_DIR", str(cache))
    return cache


@pytest.fixture(scope="module")
def sweep(cache):
    """One sweep: {memory, mmap} and a cell that fails."""
    csv = cache / "sweep.csv"
    cells = cache / "cells.json"
    ballast = np.ones(40_000_000)  # 320 MB this process has held before it forks the cells
    del ballast
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BENCH_CACHE_DIR", str(cache))
        mp.setenv("OMP_NUM_THREADS", "1")
        with pytest.raises(SystemExit) as exc:
            rbt.main(["--text-size", "2e5", "--patterns", str(COUNT), "--colds", str(COLD),
                      "--algorithms", "memory,mmap,bogus", "--device", "cpu",
                      "--no-drop-caches", "--out", str(csv), "--phases-out", str(cells)])
    return dict(exit=exc.value.code, csv=csv.read_text().splitlines(),
                cells=json.loads(cells.read_text()),
                memory=(cache / "results_memory.txt").read_bytes(),
                mmap=(cache / "results_mmap.txt").read_bytes())


@pytest.mark.parametrize("count,cold", [(10, 0.01), (1000, 0.1), (40, 0.25), (64, 1.0), (7, 0.0)])
def test_gen_patterns_equals_the_jax_scripts(env, count, cold):
    ours = rbt.gen_patterns(TEXT, count, cold, 43)
    theirs = run_benchmark.gen_patterns(TEXT, count, cold, 43)
    np.testing.assert_array_equal(ours, theirs)
    assert ours.shape == (count, 20)
    assert len({bytes(p) for p in ours}) <= max(int(np.ceil(cold * count)), 1)


def test_a_failing_cell_makes_the_sweep_exit_non_zero(sweep):
    assert sweep["exit"] not in (0, None) and "bogus" in str(sweep["exit"])
    # ... after the CSV was written, with the cells that ran
    assert sweep["csv"][0] == HEADER
    assert [ln.split(",")[:3] for ln in sweep["csv"][1:]] == [
        [str(COUNT), str(COLD), "memory"], [str(COUNT), str(COLD), "mmap"]]


def test_csv_rows_and_phases(sweep):
    for ln, cell in zip(sweep["csv"][1:], sweep["cells"]):
        _, _, algo, total_ns, load_pct, rss = ln.split(",")
        assert int(total_ns) == cell["total_ns"] > 0 and int(rss) == cell["max_rss_kb"] > 0
        assert int(load_pct) == 100 * cell["load_ns"] // cell["total_ns"]
        assert cell["algorithm"] == algo and cell["query_ns"] > 0
        assert {"import_ns", "blob_read_ns", "view_load_ns"} <= set(cell["phases"])
    memory = sweep["cells"][0]["phases"]
    assert {"upload_ns", "warm_ns"} <= set(memory) and "cuda_init_ns" not in memory


def test_peak_rss_is_the_cells_own(sweep):
    """A cell reports its own peak, not the peak its parent had when it
    forked: this process has held far more than a bare mmap cell needs, and
    ``ru_maxrss`` would hand that down across exec."""
    import resource

    ours = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    memory, mmap = (c["max_rss_kb"] for c in sweep["cells"])
    assert 0 < mmap < ours and mmap <= memory
    assert rbt.peak_rss_kb()[0] > 0
    assert all(c["max_rss_source"] == "VmHWM" for c in sweep["cells"])


def test_peak_rss_names_its_source(monkeypatch):
    """Where the kernel prints no ``VmHWM`` the fall back to ``ru_maxrss``,
    which may hold the parent's resident set, is not silent."""
    import builtins
    import io
    import resource

    assert rbt.peak_rss_kb()[1] == "VmHWM"
    monkeypatch.setattr(builtins, "open", lambda *a, **k: io.StringIO("VmPeak:\t1 kB\n"))
    assert rbt.peak_rss_kb() == (
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss, "ru_maxrss")


GOOD_CELL = json.dumps({"total_ns": 9, "load_ns": 3, "query_ns": 5, "max_rss_kb": 7,
                        "max_rss_source": "VmHWM", "phases": {"import_ns": 1}})


@pytest.mark.parametrize("rc,stdout,ok", [
    (0, "noise\n" + GOOD_CELL + "\n", True),
    (1, GOOD_CELL, False),
    (0, "", False),
    (0, "Traceback (most recent call last):", False),
    (0, "[1, 2]", False),
    (0, '{"total_ns": 9}', False),
], ids=["good", "nonzero_exit", "no_output", "not_json", "not_an_object", "keys_missing"])
def test_parse_cell(rc, stdout, ok):
    proc = subprocess.CompletedProcess([], rc, stdout=stdout, stderr="")
    assert (rbt.parse_cell(proc) is not None) == ok


def test_a_malformed_cell_line_fails_the_sweep_after_the_csv(env, monkeypatch):
    """A cell that exits 0 with a last line that is not its JSON counts as
    failed: the other cell's row is written, then the sweep exits non-zero."""
    def fake_run(cmd, **kw):
        algo = cmd[cmd.index("--algorithm") + 1]
        return subprocess.CompletedProcess(
            cmd, 0, stdout=GOOD_CELL if algo == "memory" else "not a cell", stderr="")

    monkeypatch.setattr(rbt.subprocess, "run", fake_run)
    csv = env / "malformed.csv"
    with pytest.raises(SystemExit) as exc:
        rbt.main(["--text-size", "2e5", "--patterns", "5", "--colds", "1.0", "--algorithms",
                  "mmap,memory", "--device", "cpu", "--no-drop-caches", "--out", str(csv)])
    assert "mmap" in str(exc.value.code) and "memory" not in str(exc.value.code)
    assert csv.read_text().splitlines() == [HEADER, "5,1.0,memory,9,33,7"]


def test_written_locations_equal_the_host_index(env, sweep):
    pats = rbt.gen_patterns(TEXT, COUNT, COLD, 43)
    fm = ft.FmIndex.load(np.fromfile(rbt.blob_path(TEXT), np.uint8), position="u32",
                         block=ft.BLOCK3_U64, encoder_kind="table")
    want = [fm.locate(p.tobytes()) for p in pats]
    assert all(want)
    # mmap: one comma-joined line per pattern
    lines = sweep["mmap"].decode().splitlines()
    assert [[int(x) for x in ln.split(",")] for ln in lines] == want
    # memory: every location on its own line, grouped by pattern in batch order
    flat = [int(x) for x in sweep["memory"].decode().split("\n")]
    assert flat == [x for row in want for x in row]


def test_mmap_file_equals_the_jax_scripts_cell(env, sweep):
    """The JAX-side script's ``--cell`` for ``mmap`` (it loads no JAX
    engine) writes the same bytes for the same inputs."""
    os.remove(env / "results_mmap.txt")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "run_benchmark.py"), "--cell", "--text-size",
         str(TEXT), "--patterns", str(COUNT), "--cold", str(COLD), "--algorithm", "mmap"],
        env=dict(os.environ, JAX_PLATFORMS="cpu"), cwd=REPO, capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert (env / "results_mmap.txt").read_bytes() == sweep["mmap"]


def test_device_cells_on_the_named_cpu(env):
    """``device`` (the headline upload, the stream engine) and ``device-warm``
    run where ``--device`` says; their file equals the memory cell's."""
    csv = env / "device.csv"
    rbt.main(["--text-size", "2e5", "--patterns", str(COUNT), "--colds", str(COLD),
              "--algorithms", "memory,device,device-warm", "--device", "cpu",
              "--serve-batches", "2", "--out", str(csv)])
    rows = [ln.split(",") for ln in csv.read_text().splitlines()[1:]]
    assert [r[2] for r in rows] == ["memory", "device", "device-warm"]
    assert rows[2][4] == "0"  # amortized: no load share
    memory = (env / "results_memory.txt").read_bytes()
    assert (env / "results_device.txt").read_bytes() == memory
    assert (env / "results_device-warm.txt").read_bytes() == memory


def test_serve_grid_and_merge(env):
    csv = env / "merge.csv"
    csv.write_text(HEADER + "\n10,0.5,mmap,5,0,7\n10,0.5,device-warm,9,0,0\n")
    rbt.main(["--text-size", "2e5", "--patterns", "10,30", "--colds", "0.5", "--serve-grid",
              "--device", "cpu", "--serve-batches", "2", "--merge-into", str(csv)])
    lines = csv.read_text().splitlines()
    assert lines[0] == HEADER and lines[1] == "10,0.5,mmap,5,0,7"
    assert [ln.split(",")[:3] for ln in lines[2:]] == [["10", "0.5", "device-warm"],
                                                      ["30", "0.5", "device-warm"]]
    assert all(int(ln.split(",")[3]) > 9 for ln in lines[2:])


def test_device_cell_raises_without_a_card(env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):  # the sweep, before any cell
        rbt.main(["--text-size", "2e5", "--patterns", "5", "--colds", "1.0",
                  "--algorithms", "mmap,device", "--out", str(env / "never.csv")])
    assert not (env / "never.csv").exists()
    args = rbt.argparse.Namespace(algorithm="device", text_size="2e5", patterns="5", cold="1.0",
                                  device=None, serve_batches=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rbt.run_cell(args)
