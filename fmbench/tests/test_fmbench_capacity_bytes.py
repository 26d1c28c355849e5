"""The reader of the capacity sync's bytes copied to the host
(``fmbench/metrics/capacity_bytes.locate.py``): none from a program that
does not count them, and 16 a call in a traced CPU run of a locate cell."""
import collections
import json
import types

import pytest

from conftest import run_cli, small_args
from fmbench import run as fmrun


def test_none_from_a_program_without_the_counter(monkeypatch):
    from sview_fmindex_tpu_torch import tracing as program

    reader = fmrun.metric_reader("capacity_bytes.locate")
    run = types.SimpleNamespace(trace=types.SimpleNamespace(calls=4, busy_s=0.0))
    monkeypatch.setattr(program, "COUNTS", collections.Counter(calls=4, syncs=4, rows=90))
    assert reader.read(run) is None
    monkeypatch.setattr(program, "COUNTS", collections.Counter(calls=4, capacity_bytes=64))
    assert reader.read(run) == 16.0
    run.trace.calls = 5
    assert reader.read(run) is None


def test_traced_cpu_run_reads_16_bytes_a_call():
    code, out, err = run_cli(small_args("dna20-1e8.locate-1m", trace="1"))
    assert code == 0, err[-3000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["metrics"]["capacity_bytes.locate"] == {"value": pytest.approx(16.0), "unit": "B"}
