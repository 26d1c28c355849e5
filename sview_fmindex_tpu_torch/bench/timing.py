"""Timing helpers (port of ``sview_fmindex_tpu.bench.timing``).

PyTorch returns before the card finishes, so a host clock without a
synchronise measures the enqueue.  Two clocks, chosen by the DEVICE THE
CALLER NAMES (a tensor's device, or ``device=``), never by whether a card
happens to be present:

- a CUDA device: ``timeit`` times with CUDA events around back-to-back calls,
  after one warm call, and synchronises once at the end; ``window_rates``
  gives both the event rate and the rate on a host clock that is synchronised
  before it starts and before it stops (what a caller feels);
- the CPU, only where the caller names it (``device="cpu"`` or CPU tensors):
  the host clock alone.

With no device named the CUDA path is taken, and it raises where there is no
card.
"""
from __future__ import annotations

import subprocess
import time

import torch


def _device_of(args, device) -> torch.device:
    """The device to time on: ``device`` if named, else the first tensor
    argument's, else the current CUDA device (raises where there is none)."""
    if device is None:
        for a in args:
            if isinstance(a, torch.Tensor):
                device = a.device
                break
    if device is not None:
        device = torch.device(device)
        if device.type == "cpu":
            return device
    if not torch.cuda.is_available():
        raise RuntimeError("device timing needs a CUDA device (name device='cpu' "
                           "to time on the host clock)")
    return device if device is not None else torch.device("cuda", torch.cuda.current_device())


def force(x) -> None:
    """Wait until the work queued on ``x``'s device (its producer included)
    has finished.  ``x``: a tensor or a tuple whose first element is one.
    Nothing to wait for on the CPU."""
    if isinstance(x, (tuple, list)):
        x = x[0]
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def timeit(fn, *args, reps: int = 8, device=None):
    """(warmup_s, steady_s): the first call's wall time (synchronised), then
    the mean time per call over ``reps`` back-to-back calls: from CUDA events
    on a CUDA device (the first call is not in the window), from the host
    clock for CPU tensors or ``device="cpu"``."""
    dev = _device_of(args, device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn(*args)
    if cuda:
        torch.cuda.synchronize(dev)
    warm = time.perf_counter() - t0
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        return warm, (time.perf_counter() - t0) / reps
    with torch.cuda.device(dev):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        end.synchronize()
    return warm, start.elapsed_time(end) / 1e3 / reps


def window_rates(fn, n: int, reps: int, windows: int = 5, device=None) -> dict:
    """Items/s of ``fn`` (a call that handles ``n`` items) over ``windows``
    windows of ``reps`` back-to-back calls, after one warm call that is in no
    window.  Returns ``{"host": [rate per window], "events": [...] or None}``:
    the host clock is synchronised before a window starts and before it
    stops; on a CUDA device the same window is also read from CUDA events.
    Report ``max`` AND ``min``: the best window alone is biased upward."""
    dev = _device_of((), device)
    cuda = dev.type == "cuda"
    fn()
    host, events = [], [] if cuda else None
    for _ in range(windows):
        if cuda:
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        if cuda:
            start.record()
        for _ in range(reps):
            fn()
        if cuda:
            end.record()
            torch.cuda.synchronize(dev)
        host.append(reps * n / (time.perf_counter() - t0))
        if cuda:
            events.append(reps * n / (start.elapsed_time(end) / 1e3))
    return {"host": host, "events": events}


def device_info(device) -> dict:
    """The device's name, and for a card the ``nvidia-smi`` line with its
    power limit.  The card is asked for by its UUID: ``nvidia-smi`` numbers
    every card of the host, torch only those ``CUDA_VISIBLE_DEVICES`` lets
    through, so an index would name another card."""
    if device.type != "cuda":
        return {"platform": "cpu", "name": "cpu", "smi": None}
    try:
        uuid = torch.cuda.get_device_properties(device).uuid
        smi = subprocess.run(
            ["nvidia-smi", "-i", f"GPU-{uuid}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    except (AttributeError, OSError, subprocess.CalledProcessError, IndexError):
        smi = None
    return {"platform": "gpu", "name": torch.cuda.get_device_name(device), "smi": smi}
