"""The sampled-SA cell ``dna20-1e8-sa32.locate-1m`` and the readers of the
LF walk layer it brings (``walk_busy_ms``, ``walk_idle_ms``, ``walk_steps``,
``walk_row_steps``, ``walk_lanes``, ``walk_roofline``): the cell end to end
on the CPU at a small text, correct with its control not; the roofline's
arithmetic on hand-made inputs; None from a program without the span or the
counters, and where the card gives nothing to read."""
import collections
import json
import types

import pytest
import torch

from conftest import run_cli
from fmbench import run as fmrun

CELL = "dna20-1e8-sa32.locate-1m"
BATCH = 32768
COUNTERS = ["walk_steps.locate", "walk_row_steps.locate", "walk_lanes.locate"]
SPANS = ["walk_busy_ms.locate", "walk_idle_ms.locate"]


def cell_args(trace):
    return ["--workload", CELL, "--seed", "3141592653589", "--seconds", "0.5",
            "--trace", trace, "--device", "cpu", "--text-size", "1000000",
            "--batch", str(BATCH), "--control"]


@pytest.mark.parametrize("trace", ["0", "1"])
def test_cell_is_correct_and_its_control_is_not(trace):
    code, out, err = run_cli(cell_args(trace))
    assert code == 0, err[-3000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["control"]["correct"] is False, res["control"]
    metrics = {k: v["value"] for k, v in res["metrics"].items()}
    if trace == "0":
        assert set(metrics) == {"locate_qps", "setup_s"}
        return
    # SA every 32nd row: a located row takes 31 LF steps on average, and
    # the last of ~32k rows ends after about 32 ln(32k) steps
    assert metrics["rows.locate"] == pytest.approx(BATCH, rel=1e-3)
    assert 28 * BATCH < metrics["walk_row_steps.locate"] < 34 * BATCH
    assert 200 < metrics["walk_steps.locate"] < 700
    assert metrics["syncs.locate"] == metrics["walk_steps.locate"] + 2
    assert metrics["walk_lanes.locate"] == metrics["walk_steps.locate"] * metrics["slots.locate"]
    # no card: no device time and no roofline
    assert not set(SPANS + ["walk_roofline.locate"]) & set(metrics)


def test_work_bytes_by_hand():
    reader = fmrun.metric_reader("walk_roofline.locate")
    assert reader.work_bytes(0, 0) == 0
    assert reader.work_bytes(1, 0) == 36
    assert reader.work_bytes(0, 1) == 16
    # a 1M call, SA every 32nd row: 31 steps a row
    assert reader.work_bytes(32_505_856, 1_048_576) == 36 * 32_505_856 + 16 * 1_048_576 \
        == 1_186_988_032


CARD = "NVIDIA H100 80GB HBM3"


def fake_run(device, calls=4, walk_ms=150.0):
    return types.SimpleNamespace(
        device=device, trace=types.SimpleNamespace(calls=calls, busy_s=1.0),
        probes={"spans": {"busy_ms": {"fmindex.walk": walk_ms},
                          "idle_ms": {"fmindex.walk": 40.0}}},
        details={})


def test_roofline_by_hand(monkeypatch):
    from sview_fmindex_tpu_torch import tracing as program

    reader = fmrun.metric_reader("walk_roofline.locate")
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: CARD)
    monkeypatch.setattr(program, "COUNTS", collections.Counter(
        calls=4, rows=4 * 1_000_000, walk_row_steps=4 * 31_000_000))
    run = fake_run(torch.device("cuda", 0))
    want = 100 * (36 * 31_000_000 + 16 * 1_000_000) / 3.35e12 / 150e-3
    assert reader.read(run) == pytest.approx(want)
    assert 0 < reader.read(run) < 100


@pytest.mark.parametrize("case", ["cpu", "card-not-in-peaks", "no-rows", "no-row-steps",
                                  "no-walk-span", "calls-not-the-window"])
def test_roofline_none_without_its_inputs(case, monkeypatch):
    from sview_fmindex_tpu_torch import tracing as program

    reader = fmrun.metric_reader("walk_roofline.locate")
    name = "Some Card" if case == "card-not-in-peaks" else CARD
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    counts = collections.Counter(calls=4, rows=4_000_000, walk_row_steps=124_000_000)
    if case == "no-rows":
        del counts["rows"]
    if case == "no-row-steps":
        del counts["walk_row_steps"]
    monkeypatch.setattr(program, "COUNTS", counts)
    device = torch.device("cpu") if case == "cpu" else torch.device("cuda", 0)
    run = fake_run(device, calls=5 if case == "calls-not-the-window" else 4)
    if case == "no-walk-span":
        run.probes["spans"]["busy_ms"] = {}
    assert reader.read(run) is None


@pytest.mark.parametrize("name", COUNTERS)
def test_counters_none_from_a_program_without_them(name, monkeypatch):
    from sview_fmindex_tpu_torch import tracing as program

    key = name.split(".")[0]
    reader = fmrun.metric_reader(name)
    run = types.SimpleNamespace(trace=types.SimpleNamespace(calls=4, busy_s=0.0))
    # a program that does not count the walk, or a window with no walk
    monkeypatch.setattr(program, "COUNTS", collections.Counter(calls=4, syncs=1840, rows=40))
    assert reader.read(run) is None
    monkeypatch.setattr(program, "COUNTS", collections.Counter(calls=4, **{key: 40}))
    assert reader.read(run) == 10.0
    # a walk that ran and decoded nothing reads 0, not None
    monkeypatch.setattr(program, "COUNTS", collections.Counter(calls=4, **{key: 0}))
    assert reader.read(run) == 0.0
    run.trace.calls = 5
    assert reader.read(run) is None


@pytest.mark.parametrize("name", SPANS)
def test_span_readers_none_from_a_program_without_the_span(name):
    reader = fmrun.metric_reader(name)
    run = fake_run(torch.device("cuda", 0))
    assert reader.read(run) == (150.0 if "busy" in name else 40.0)
    # the parent's program: resolve holds the walk, no span of its own
    run.probes["spans"] = {"busy_ms": {"fmindex.resolve": 190.0},
                           "idle_ms": {"fmindex.resolve": 40.0}}
    assert reader.read(run) is None
    # a run with no device events
    run.trace.busy_s = 0.0
    assert reader.read(run) is None
