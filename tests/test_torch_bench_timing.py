"""``sview_fmindex_tpu_torch/bench/timing.py``: the clock follows the device
the caller names, never whether a card happens to be present."""
import pytest

torch = pytest.importorskip("torch")

from sview_fmindex_tpu_torch.bench import timing  # noqa: E402


def _work(x):
    return (x * 2 + 1).sum()


def test_timeit_cpu_tensors_use_the_host_clock():
    warm, steady = timing.timeit(_work, torch.arange(50_000), reps=4)
    assert warm > 0 and steady > 0


def test_timeit_named_cpu_without_tensor_arguments():
    x = torch.arange(10_000)
    warm, steady = timing.timeit(lambda: _work(x), reps=3, device="cpu")
    assert warm > 0 and steady > 0


@pytest.mark.parametrize("call", [
    lambda: timing.timeit(lambda: None, reps=2),
    lambda: timing.timeit(lambda: None, reps=2, device="cuda"),
    lambda: timing.window_rates(lambda: None, 10, 2),
    lambda: timing.window_rates(lambda: None, 10, 2, device="cuda:0"),
], ids=["timeit", "timeit_cuda", "window_rates", "window_rates_cuda"])
def test_no_device_named_and_no_card_raises(monkeypatch, call):
    """With no device named the CUDA path is taken, and it raises where
    there is no card: nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        call()


def test_window_rates_reports_every_window_on_the_cpu():
    x = torch.arange(20_000)
    calls = []
    w = timing.window_rates(lambda: calls.append(_work(x)), n=20_000, reps=3, windows=4,
                            device="cpu")
    assert w["events"] is None and len(w["host"]) == 4
    assert all(r > 0 for r in w["host"]) and min(w["host"]) <= max(w["host"])
    assert len(calls) == 1 + 3 * 4  # one warm call, in no window


def test_force_takes_cpu_tensors_and_tuples():
    timing.force(torch.arange(3))
    timing.force((torch.arange(3), None))


@pytest.mark.cuda
def test_cuda_tensors_are_timed_with_events():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.arange(1 << 20, device="cuda")
    warm, steady = timing.timeit(_work, x, reps=4)
    w = timing.window_rates(lambda: _work(x), 1 << 20, 4, 3)
    assert warm > 0 and steady > 0 and len(w["events"]) == 3 and min(w["events"]) > 0
