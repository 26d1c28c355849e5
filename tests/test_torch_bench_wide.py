"""``tools/torch_wide_bench.py`` on the CPU at 2e5 bp: both wide engines are
named by ``engine_for``, the parity string is there, and the JSON goes where
``--out`` says."""
import importlib.util
import json
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load():
    spec = importlib.util.spec_from_file_location(
        "torch_wide_bench", os.path.join(REPO, "tools", "torch_wide_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("wide_bench")
    old = {k: os.environ.get(k) for k in ("BENCH_TEXT_SIZE", "WIDE_BENCH_BATCH", "BENCH_CACHE_DIR")}
    os.environ.update(BENCH_TEXT_SIZE="2e5", WIDE_BENCH_BATCH="300", BENCH_CACHE_DIR=str(d))
    try:
        mod = _load()
        out = mod.main(["--device", "cpu", "--out", str(d / "wide.json")])
    finally:
        for k, v in old.items():
            os.environ.pop(k, None) if v is None else os.environ.__setitem__(k, v)
    return mod, out, d


def test_parity_and_engines(run):
    _, out, _ = run
    assert out["parity"] == ("ok (stream==gather, 200 locations re-verified, "
                             "64 counts vs host oracle)")
    assert out["text_size"] == 200_000 and out["batch"] == 300
    for engine in ("wide-stream", "wide-gather"):
        r = out[engine]
        assert 0 < r["count_qps_worst"] <= r["count_qps"]
        assert 0 < r["locate_qps_worst"] <= r["locate_qps"]
        assert r["count_qps_events"] is None
    # the run's own join launches, per call; none is counted for CPU tensors
    assert out["launches"] == {"upload": {}, "wide-stream count": {}, "wide-stream locate": {},
                               "wide-gather count": {}, "wide-gather locate": {}}


def test_out_file_is_where_asked_and_nowhere_else(run):
    _, out, d = run
    with open(d / "wide.json") as f:
        assert json.load(f) == out
    # the JAX script's committed artifact is not this script's to write
    with open(os.path.join(REPO, "WIDE_BENCH_r05.json")) as f:
        assert "backend" in json.load(f)


def test_engine_for_must_name_the_engine_asked_for(run, monkeypatch):
    mod, _, d = run
    from sview_fmindex_tpu_torch.models.device_index import DeviceFmIndex

    monkeypatch.setenv("BENCH_TEXT_SIZE", "2e5")
    monkeypatch.setenv("WIDE_BENCH_BATCH", "50")
    monkeypatch.setenv("BENCH_CACHE_DIR", str(d))
    monkeypatch.setattr(DeviceFmIndex, "engine_for", lambda self, B, use_stream=None,
                        use_pair=True: "wide-gather")
    with pytest.raises(RuntimeError, match="engine_for names wide-gather, not wide-stream"):
        mod.main(["--device", "cpu"])


def test_raises_without_a_card_unless_the_cpu_is_named(run, monkeypatch):
    mod, _, _ = run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
