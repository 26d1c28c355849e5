"""The collection cell ``ecoli23-113m.locate-1m`` and the readers of the
resolve layer it brings (``rows.locate``, ``slots.locate``,
``resolve_roofline.locate``): the cell end to end on the CPU at a small
text, correct with its control not; the readers' arithmetic on hand-made
inputs; None where the program or the card gives nothing to read."""
import collections
import json
import types

import pytest
import torch

from conftest import run_cli
from fmbench import run as fmrun

CELL = "ecoli23-113m.locate-1m"
BATCH = 32768
READERS = ["rows.locate", "slots.locate"]


def cell_args(trace):
    return ["--workload", CELL, "--seed", "2718281828459", "--seconds", "0.5",
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
    # 23 copies at d = 0.01: about 1 + 22 x 0.99^40 = 15.7 rows a pattern
    assert metrics["rows.locate"] > 3 * BATCH, metrics
    assert metrics["slots.locate"] >= metrics["rows.locate"]
    # no card, no roofline
    assert "resolve_roofline.locate" not in metrics


def test_work_bytes_by_hand():
    reader = fmrun.metric_reader("resolve_roofline.locate")
    assert reader.work_bytes(0, 0) == 0
    assert reader.work_bytes(1, 0) == 8
    assert reader.work_bytes(0, 1) == 12
    # a 1M call at 15.73 rows a pattern
    assert reader.work_bytes(1048576, 16494100) == 8 * 1048576 + 12 * 16494100 == 206317808


def fake_run(device, calls=4, resolve_ms=2.0, batch=1048576, pool=8):
    pats = torch.zeros((batch, 1), dtype=torch.uint8)
    return types.SimpleNamespace(
        device=device, pool=[(pats, None)] * pool,
        trace=types.SimpleNamespace(calls=calls, busy_s=1.0),
        probes={"spans": {"busy_ms": {"fmindex.resolve": resolve_ms}, "idle_ms": {}}},
        details={})


CARD = "NVIDIA H100 80GB HBM3"


def test_roofline_by_hand(monkeypatch):
    from sview_fmindex_tpu_torch import tracing as program

    reader = fmrun.metric_reader("resolve_roofline.locate")
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: CARD)
    monkeypatch.setattr(program, "COUNTS", collections.Counter(calls=4, rows=4 * 16_000_000))
    run = fake_run(torch.device("cuda", 0))
    want = 100 * (8 * 1048576 + 12 * 16_000_000) / 3.35e12 / 2e-3
    assert reader.read(run) == pytest.approx(want)
    assert 0 < reader.read(run) < 100


@pytest.mark.parametrize("case", ["cpu", "card-not-in-peaks", "no-rows", "no-resolve-span",
                                  "calls-not-the-window"])
def test_roofline_none_without_its_inputs(case, monkeypatch):
    from sview_fmindex_tpu_torch import tracing as program

    reader = fmrun.metric_reader("resolve_roofline.locate")
    name = "Some Card" if case == "card-not-in-peaks" else CARD
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    counts = collections.Counter(calls=4, rows=64_000_000)
    if case == "no-rows":
        del counts["rows"]
    monkeypatch.setattr(program, "COUNTS", counts)
    device = torch.device("cpu") if case == "cpu" else torch.device("cuda", 0)
    run = fake_run(device, calls=5 if case == "calls-not-the-window" else 4)
    if case == "no-resolve-span":
        run.probes["spans"]["busy_ms"] = {}
    assert reader.read(run) is None


@pytest.mark.parametrize("name", READERS)
def test_counters_none_from_a_program_without_them(name, monkeypatch):
    from sview_fmindex_tpu_torch import tracing as program

    key = name.split(".")[0]
    reader = fmrun.metric_reader(name)
    run = types.SimpleNamespace(trace=types.SimpleNamespace(calls=4, busy_s=0.0))
    monkeypatch.setattr(program, "COUNTS", collections.Counter(calls=4, syncs=4))
    assert reader.read(run) is None
    monkeypatch.setattr(program, "COUNTS", collections.Counter(calls=4, **{key: 40}))
    assert reader.read(run) == 10.0
    run.trace.calls = 5
    assert reader.read(run) is None
