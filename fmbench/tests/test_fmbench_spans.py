"""The traced window put down to the program's layers (``fmbench/spans.py``):
a hand-made trace worked by hand, and traced runs of two cells on the CPU,
which read the program's counters and no device time."""
import collections
import json
import types

import pytest

from conftest import run_cli, small_args
from fmbench import spans, tracing


def _x(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _span(name, ts, dur):
    return _x(name, "user_annotation", ts, dur)


# one call of the window [0, 200] us: its spans, the runtime calls that
# launch, and what each launch ran on the device
CALL_SPANS = [
    _span(tracing.WINDOW, 0, 200),
    _span(tracing.CALL, 0, 190),
    _span("fmindex.locate", 10, 170),       # [10, 180]
    _span("fmindex.intake", 10, 30),        # [10, 40]
    _span("fmindex.search", 40, 60),        # [40, 100]
    _span("fmindex.capacity", 100, 30),     # [100, 130]
    _span("fmindex.resolve", 130, 40),      # [130, 170]
]
LAUNCHES = [
    _x("cudaMemcpyAsync", "cuda_runtime", 15, 20, corr=1),    # intake
    _x("cudaLaunchKernel", "cuda_runtime", 45, 5, corr=2),    # search
    _x("cudaMemsetAsync", "cuda_runtime", 46, 2, corr=8),     # search
    _x("cudaLaunchKernel", "cuda_runtime", 95, 3, corr=3),    # search, runs in capacity
    _x("cudaMemcpyAsync", "cuda_runtime", 112, 10, corr=4),   # capacity
    _x("cudaLaunchKernel", "cuda_runtime", 132, 2, corr=5),   # resolve
    _x("cudaLaunchKernel", "cuda_runtime", 172, 2, corr=6),   # locate's own
    _x("cudaMemcpyAsync", "cuda_runtime", 182, 6, corr=7),    # the harness's copy
    _x("aten::sort", "cpu_op", 44, 20),
]
DEVICE = [
    _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 20, 15, corr=1),  # [20, 35]
    _x("void cub::DeviceRadixSortOnesweepKernel<int>(int*)", "kernel", 50, 40, corr=2),
    _x("Memset (Device)", "gpu_memset", 85, 10, corr=8),    # overlaps: adds [90, 95]
    _x("void join_kernel<4, false, false>(JoinArgs)", "kernel", 100, 10, corr=3),
    _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 112, 6, corr=4),
    _x("void gather_kernel<long>(long*)", "kernel", 135, 15, corr=5),
    _x("void sub_kernel<long>(long*)", "kernel", 172, 4, corr=6),
    _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 183, 4, corr=7),
    _x("void stray_kernel(int*)", "kernel", 192, 3, corr=99),   # no launch found
]
# us per bucket, worked by hand (the window has 2 calls, so ms per call is
# us / 2 / 1000)
BUSY_US = {"fmindex.intake": 15, "fmindex.search": 40 + 5 + 10, "fmindex.capacity": 6,
           "fmindex.resolve": 15, "api": 4, "harness": 4, "unattributed": 3}
# gaps [0,20] [35,50] [95,100] [110,112] [118,135] [150,172] [176,183]
# [187,192] [195,200], each cut at the spans' ends
IDLE_US = {"harness": 10 + 3 + 3, "fmindex.intake": 10 + 5, "fmindex.search": 10 + 5,
           "fmindex.capacity": 2 + 12, "fmindex.resolve": 5 + 20, "api": 2 + 4,
           "loop": 2 + 5}


def _ms(us: dict) -> dict:
    return {k: v / 2 / 1000 for k, v in us.items()}


def test_attribution_by_hand():
    events = CALL_SPANS + LAUNCHES + DEVICE
    got = spans.attribute(events, calls=2)
    assert got["busy_ms"] == pytest.approx(_ms(BUSY_US))
    assert got["idle_ms"] == pytest.approx(_ms(IDLE_US))
    # the buckets close on the window's own busy and idle time
    whole = tracing.TraceSummary(events, calls=2)
    assert got["busy_s"] == pytest.approx(whole.busy_s)
    assert got["idle_s"] == pytest.approx(whole.window_s - whole.busy_s)
    assert sum(BUSY_US.values()) + sum(IDLE_US.values()) == 200


def test_a_program_without_spans_has_no_layer():
    events = [e for e in CALL_SPANS + LAUNCHES + DEVICE if not e["name"].startswith("fmindex.")]
    got = spans.attribute(events, calls=2)
    assert not [k for k in list(got["busy_ms"]) + list(got["idle_ms"]) if k.startswith("fmindex.")]
    assert got["busy_s"] == pytest.approx(102e-6)
    run = types.SimpleNamespace(trace=types.SimpleNamespace(calls=2, busy_s=got["busy_s"]),
                                probes={"spans": got}, details={})
    assert spans.busy_ms(run, "fmindex.intake") is None
    assert spans.idle_ms(run, "fmindex.search") is None
    # every launch of the call is the harness's, the stray kernel still unattributed
    assert got["busy_ms"] == pytest.approx({"harness": 99 / 2e3, "unattributed": 3 / 2e3})


def test_counters_need_the_windows_calls(monkeypatch):
    from sview_fmindex_tpu_torch import tracing as program

    monkeypatch.setattr(program, "COUNTS", collections.Counter(
        calls=4, intake_bytes=4_000_000, syncs=4))
    run = types.SimpleNamespace(trace=types.SimpleNamespace(calls=4, busy_s=0.0))
    assert spans.per_call(run, "intake_bytes", 1e-6) == 1.0
    assert spans.per_call(run, "syncs") == 1.0
    run.trace.calls = 5
    assert spans.per_call(run, "syncs") is None


@pytest.mark.parametrize("cell,metrics", [
    ("dna20-1e8.locate-1m", {"intake_mb.locate": 32768 * 20 / 1e6, "syncs.locate": 1.0}),
    ("dna20-1e8.count-1m", {"intake_mb.count": 32768 * 20 / 1e6}),
])
def test_traced_cpu_run_reads_the_counters_and_no_device_time(cell, metrics):
    code, out, err = run_cli(small_args(cell, trace="1"))
    assert code == 0, err[-3000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True
    for name, value in metrics.items():
        assert res["metrics"][name]["value"] == pytest.approx(value), name
    assert not [m for m in res["metrics"] if "_busy_ms." in m or "_idle_ms." in m]
