"""``sview_fmindex_tpu_torch/bench/scaling.py``: the pattern-DP scaling report
over 1 and 2 gloo ranks on the CPU (one in this process, two as child
processes), against the JAX package's report on its CPU mesh: the same keys,
the same row keys, ``virtual`` true, every count >= 1 (a report is only made
when they are)."""
import json
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from sview_fmindex_tpu.bench import scaling as jscaling  # noqa: E402
from sview_fmindex_tpu_torch.bench import cli as tcli  # noqa: E402
from sview_fmindex_tpu_torch.bench import scaling as tscaling  # noqa: E402

TEXT, PATTERNS = 60_000, 400


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    work = tmp_path_factory.mktemp("scaling")
    port = tscaling.run_scaling(TEXT, PATTERNS, device="cpu", mesh_sizes=[1, 2], workdir=work)
    jax = jscaling.run_scaling(TEXT, PATTERNS, mesh_sizes=[1])
    return port, jax, work


def test_report_keys_equal_the_jax_reports(reports):
    port, jax, _ = reports
    assert list(port) == list(jax)
    assert [list(r) for r in port["rows"]] == [list(jax["rows"][0])] * 2
    for k in ("metric", "text_len", "pattern_count", "platform", "virtual"):
        assert port[k] == jax[k], k
    assert port["virtual"] is True and port["platform"] == "cpu"


def test_rows(reports):
    port, _, _ = reports
    assert [r["devices"] for r in port["rows"]] == [1, 2]
    assert port["rows"][0]["speedup"] == 1.0 and port["rows"][0]["efficiency"] == 1.0
    for r in port["rows"]:
        assert r["count_qps"] > 0
        assert r["efficiency"] == pytest.approx(r["speedup"] / r["devices"], abs=0.006)


def test_every_rank_counted_every_pattern(reports):
    """Each rank checks counts >= 1 before it times; rank 0 of the 2-rank
    world reports the hits of the whole batch and its backend."""
    _, _, work = reports
    with open(work / "result2_0.json") as f:
        r0 = json.load(f)
    with open(work / "result2_1.json") as f:
        r1 = json.load(f)
    assert r0["backend"] == r1["backend"] == "gloo"
    assert r0["hits"] == r1["hits"] >= PATTERNS
    assert not torch.distributed.is_initialized()


def test_a_failing_rank_fails_the_report_and_kills_its_peers(tmp_path, monkeypatch):
    """No blob in the work directory: both children fail, the report raises
    with their logs, and no child is left running."""
    with pytest.raises(RuntimeError, match=r"rank \d of 2 exited with code"):
        tscaling._spawn(str(tmp_path), 2, "cpu")
    assert sorted(p for p in os.listdir(tmp_path) if p.endswith(".log")) == [
        "rank2_0.log", "rank2_1.log"]


def test_a_work_directory_can_be_used_again(reports):
    """A second report over the same directory starts from fresh rendezvous
    files, not the ones the first run left."""
    _, _, work = reports
    (work / "store1").write_bytes(b"stale")
    rep = tscaling.run_scaling(TEXT, 50, device="cpu", mesh_sizes=[1], workdir=work)
    assert rep["rows"][0]["devices"] == 1 and rep["rows"][0]["count_qps"] > 0


def test_cli_subcommand(capsys):
    tcli.main(["scaling", "-t", "30000", "-n", "100", "--device", "cpu", "--ranks", "1"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["metric"] == "pattern_dp_count_scaling" and len(rep["rows"]) == 1


def test_raises_without_a_card_unless_the_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tscaling.run_scaling(30_000, 50, mesh_sizes=[1])
