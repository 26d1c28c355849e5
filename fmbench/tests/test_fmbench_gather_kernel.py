"""The reader of the searches the gather engine's kernel served
(``fmbench/metrics/gather_kernel.locate.py``): none from a program without
the kernel, and 0 a call in a traced CPU run, where the gather engine is
the plain per-step loop and the 1M cells take a stream engine."""
import collections
import json
import types

import pytest

from conftest import run_cli, small_args
from fmbench import run as fmrun


def test_none_from_a_program_without_the_kernel(monkeypatch):
    from sview_fmindex_tpu_torch import tracing as program
    from sview_fmindex_tpu_torch.ops import search

    reader = fmrun.metric_reader("gather_kernel.locate")
    run = types.SimpleNamespace(trace=types.SimpleNamespace(calls=4, busy_s=0.0))
    # no launch in the window: the key is never added
    monkeypatch.setattr(program, "COUNTS", collections.Counter(calls=4, syncs=4, rows=90))
    assert reader.read(run) == 0.0
    monkeypatch.setattr(program, "COUNTS", collections.Counter(calls=4, gather_kernel=4))
    assert reader.read(run) == 1.0
    run.trace.calls = 5
    assert reader.read(run) is None
    run.trace.calls = 4
    monkeypatch.delattr(search, "gather_ranges_cuda")
    assert reader.read(run) is None


@pytest.mark.parametrize("cell", ["dna20-1e8.serve-4k", "dna20-1e8.locate-1m"])
def test_traced_cpu_run_reads_0(cell):
    code, out, err = run_cli(small_args(cell, trace="1"))
    assert code == 0, err[-3000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["metrics"]["gather_kernel.locate"] == {"value": 0.0, "unit": "calls"}
