"""The reader of the LF walks the walk's kernel served
(``fmbench/metrics/walk_kernel.locate.py``): per call from the program's
counters, none from a program without the kernel or a window whose calls
the program did not count, 0 where the walk is the plain loop (a CPU index
under a profiler), and declared for the sampled-SA cell alone."""
import collections
import json
import os
import types

import numpy as np

from conftest import ROOT
from fmbench import run as fmrun

CELL = "dna20-1e8-sa32.locate-1m"


def test_per_call_and_none_from_a_program_without_the_kernel(monkeypatch):
    from sview_fmindex_tpu_torch import tracing as program
    from sview_fmindex_tpu_torch.ops import locate

    reader = fmrun.metric_reader("walk_kernel.locate")
    run = types.SimpleNamespace(trace=types.SimpleNamespace(calls=4, busy_s=0.0))
    # no launch in the window: the key is never added
    monkeypatch.setattr(program, "COUNTS", collections.Counter(calls=4, syncs=1792, rows=90))
    assert reader.read(run) == 0.0
    monkeypatch.setattr(program, "COUNTS", collections.Counter(calls=4, walk_kernel=4))
    assert reader.read(run) == 1.0
    run.trace.calls = 5
    assert reader.read(run) is None
    run.trace.calls = 4
    monkeypatch.delattr(locate, "walk_rows_cuda")
    assert reader.read(run) is None


def test_plain_walk_on_the_cpu_reads_0(monkeypatch):
    """A locate call that walks on a CPU index, traced as the harness
    traces it: the walk's counters are there, ``walk_kernel`` is not, and
    the reader gives 0 a call."""
    import torch

    import sview_fmindex_tpu_torch as ft
    from sview_fmindex_tpu_torch import tracing as program

    rng = np.random.default_rng(25)
    text = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=5000)]
    enc = ft.EncodingTable.from_symbols([b"A", b"C", b"G", b"T"])
    b = ft.FmIndexBuilder(len(text), 4, enc, position="u32", block=ft.BLOCK3_U64,
                          suffix_array_config=ft.SuffixArrayConfig.compressed(32),
                          lookup_table_config=ft.LookupTableConfig.kmer_size(3),
                          sa_backend="numpy")
    fm = ft.FmIndex.load(np.frombuffer(b.build(text.tobytes()), np.uint8), position="u32",
                         block=ft.BLOCK3_U64)
    dev = ft.to_device_torch(fm, "cpu", dense_lut_entries=0)
    starts = rng.integers(0, len(text) - 20, size=64)
    pats = torch.from_numpy(np.ascontiguousarray(text[starts[:, None] + np.arange(20)]))
    monkeypatch.setattr(program, "COUNTS", collections.Counter())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        dev.locate_with_counts(pats)
        dev.locate_with_counts(pats)
    assert program.COUNTS["walk_steps"] > 0 and "walk_kernel" not in program.COUNTS
    run = types.SimpleNamespace(trace=types.SimpleNamespace(calls=2, busy_s=0.0))
    assert fmrun.metric_reader("walk_kernel.locate").read(run) == 0.0


def test_declared_for_the_sampled_sa_cell():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    (metric,) = [m for m in bench["per_layer"] if m["name"] == "walk_kernel.locate"]
    assert metric == {"name": "walk_kernel.locate", "unit": "calls", "better": "higher",
                      "source": "program_counter", "layer": "LF walk", "moves": "locate_qps",
                      "workloads": [CELL]}
    assert bench["per_layer"][-1] is metric
    layers = {m["layer"] for m in bench["per_layer"] if m["name"].startswith("walk_")}
    assert layers == {"LF walk"}
    reported = {"locate_qps", "setup_s"}
    assert [w["name"] for w in bench["workloads"] if fmrun.applies(metric, w["name"], reported)] \
        == [CELL]
