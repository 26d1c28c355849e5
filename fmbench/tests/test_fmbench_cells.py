"""Every cell end to end on the CPU, in a fresh process as a check runs
it: the last line is the result, ``correct`` is true, and nothing of JAX
or the JAX package was loaded."""
import json

import pytest

from conftest import SMALL, run_cli, small_args

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def result_of(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_cell_end_to_end(cell):
    code, out, err = run_cli(small_args(cell))
    assert code == 0, err[-3000:]
    res = result_of(out)
    # the contract's five keys, then the numbers compared, last
    assert list(res) == KEYS
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert "setup_s" in res["metrics"]
    assert res["device"]["platform"] == "cpu"
    for name, check in res["checks"].items():
        assert check["value"] <= check["limit"], name
        assert f"check {name} {check['value']} limit {check['limit']}" in err
    # the numbers compared also end standard error
    assert err.strip().splitlines()[-1].startswith("check ")


def test_traced_run_reports_its_per_layer_metrics():
    code, out, err = run_cli(small_args("dna20-1e8.locate-1m", trace="1"))
    assert code == 0, err[-3000:]
    res = result_of(out)
    assert res["correct"] is True
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    # what a CPU run can read: the host's clocks and the program's spans;
    # the device's numbers need a card and are left out, never written as 0
    assert {"import_s", "build_s", "upload_s", "resolve_ms.locate"} <= set(res["metrics"])
    assert not {"sort_ms.locate", "join_ms.locate", "join_roofline.locate",
                "idle_share.locate"} & set(res["metrics"])
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_control_is_not_correct():
    """The control (each pattern matched on its seed alone) must be judged
    wrong on every cell's numbers it can fail, while the program is right."""
    code, out, err = run_cli(small_args("prot20-1e8.locate-mixed-1m", extra=["--control"]))
    assert code == 0, err[-3000:]
    res = result_of(out)
    assert res["correct"] is True
    assert res["control"]["correct"] is False
    assert res["control"]["checks"]["count_mismatch"]["value"] > 0
    assert res["control"]["checks"]["locate_mismatch"]["value"] > 0


def test_no_card_no_result():
    """Without ``--device cpu`` a machine with no card gives no result and
    a non-zero exit: the run never falls back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    code, out, err = run_cli(["--workload", "dna20-1e8.locate-1m", "--seed", "1",
                              "--seconds", "1", "--trace", "0"])
    assert code != 0
    assert out.strip() == ""
    assert "CUDA device" in err


def test_unknown_workload_fails():
    code, out, _ = run_cli(["--workload", "nope", "--seed", "1", "--seconds", "1",
                            "--trace", "0", "--device", "cpu"])
    assert code != 0 and out.strip() == ""


@pytest.mark.cuda
def test_cell_on_card(cuda_device):
    """A small locate cell on the card: the join kernel's path, correct."""
    code, out, err = run_cli(["--workload", "dna20-1e8.locate-1m", "--seed", "5", "--seconds",
                              "1", "--trace", "1", "--text-size", "1000000", "--batch", "65536"])
    assert code == 0, err[-3000:]
    res = result_of(out)
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
