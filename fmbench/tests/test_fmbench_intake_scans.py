"""The readers of batch intake's scans over per-lane lengths
(``fmbench/metrics/intake_scans.*.py``): none from a program that does not
count them, and 0 or 1 a call in traced CPU runs by whether the cell's
traffic hands in lengths."""
import collections
import json
import types

import pytest

from conftest import run_cli, small_args
from fmbench import run as fmrun

READERS = ["intake_scans.locate", "intake_scans.count"]


@pytest.mark.parametrize("name", READERS)
def test_none_from_a_program_without_the_counter(name, monkeypatch):
    from sview_fmindex_tpu_torch import tracing as program

    reader = fmrun.metric_reader(name)
    run = types.SimpleNamespace(trace=types.SimpleNamespace(calls=4, busy_s=0.0))
    monkeypatch.setattr(program, "COUNTS", collections.Counter(calls=4, intake_bytes=80))
    assert reader.read(run) is None
    monkeypatch.setattr(program, "COUNTS", collections.Counter(calls=4, intake_scans=0))
    assert reader.read(run) == 0.0
    monkeypatch.setattr(program, "COUNTS", collections.Counter(calls=4, intake_scans=4))
    assert reader.read(run) == 1.0
    run.trace.calls = 5
    assert reader.read(run) is None


@pytest.mark.parametrize("cell,name,value", [
    ("dna20-1e8.count-1m", "intake_scans.count", 0.0),
    ("prot20-1e8.locate-mixed-1m", "intake_scans.locate", 1.0),
])
def test_traced_cpu_run_reads_the_scans(cell, name, value):
    code, out, err = run_cli(small_args(cell, trace="1"))
    assert code == 0, err[-3000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["metrics"][name] == {"value": pytest.approx(value), "unit": "scans"}
