"""The traced window put down to the program's layers: its spans in the
Chrome trace of a traced run, and its counters.

The program (``sview_fmindex_tpu_torch/tracing.py``) opens a
``record_function`` span at each layer of the query path while the profiler
records: ``fmindex.locate`` or ``fmindex.count`` around a call, and inside it
``fmindex.intake``, ``fmindex.search``, ``fmindex.capacity`` and
``fmindex.resolve``.  Over the window (``tracing.WINDOW``):

- **busy**: each kernel, copy or memset goes to the innermost span that holds
  the start of the runtime call that launched it (matched by
  ``args.correlation``); a top span's own part is ``api``, a launch outside
  the program's spans but inside ``fmbench.call`` is ``harness``, outside
  that ``loop``, and a device event with no launching call found is
  ``unattributed``.  Where device events overlap, each instant counts once,
  for the event that started first, so the buckets sum to the window's busy
  time.
- **idle**: each stretch of the window with nothing on the device, cut at the
  spans' ends, goes piece by piece to the innermost span covering it, with
  the same ``api``, ``harness`` and ``loop``.

Milliseconds per call of the window.  A program without these spans (or a
run without device events) gives no bucket of a layer, and its readers
return None.
"""
from __future__ import annotations

import bisect
import json
import os

from fmbench import tracing

PROGRAM = "fmindex."
TOP = ("fmindex.locate", "fmindex.count")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bucket(name: str) -> str:
    if name == tracing.WINDOW:
        return "loop"
    if name == tracing.CALL:
        return "harness"
    return "api" if name in TOP else name


class Spans:
    """The window's spans (``fmbench.window``, ``fmbench.call`` and the
    program's), which nest: one caller thread opens them all."""

    def __init__(self, events: list):
        self.spans = sorted(
            ((float(e["ts"]), float(e["ts"]) + float(e["dur"]), _bucket(e["name"]))
             for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and (e["name"] in (tracing.WINDOW, tracing.CALL) or e["name"].startswith(PROGRAM))),
            key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]
        self.bounds = sorted({t for a, b, _ in self.spans for t in (a, b)})

    def at(self, t: float) -> str:
        """The bucket of the innermost span open at ``t``: the latest one
        started that has not ended (a parent sorts before a child that
        starts with it)."""
        for i in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            _, end, name = self.spans[i]
            if end > t:
                return name
        return "loop"


def attribute(events: list, calls: int) -> dict:
    """{"busy_ms": {bucket: ms per call}, "idle_ms": {...}, "busy_s",
    "idle_s"} over the window of ``events`` (a Chrome trace's events)."""
    win = [e for e in events if e.get("name") == tracing.WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError(f"no {tracing.WINDOW} span in the trace")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    spans = Spans(events)
    launched = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS and corr is not None:
            launched[corr] = min(float(e["ts"]), launched.get(corr, float("inf")))
    device = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in tracing.DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e.get("dur", 0)), w1)
        if b > a:
            device.append((a, b, (e.get("args") or {}).get("correlation")))
    device.sort(key=lambda x: (x[0], x[1]))
    layers = {b for _, _, b in spans.spans if b.startswith(PROGRAM)}
    busy = dict.fromkeys(sorted(layers), 0.0)
    idle = dict.fromkeys(sorted(layers), 0.0)
    # the union of the device events, each instant once; the gaps between
    # them are the idle stretches
    t = w0
    for a, b, corr in device:
        if a > t:
            _idle(spans, idle, t, a)
        if b > t:
            start = launched.get(corr)
            name = "unattributed" if start is None else spans.at(start)
            busy[name] = busy.get(name, 0.0) + b - max(a, t)
            t = b
    if w1 > t:
        _idle(spans, idle, t, w1)
    per_call = 1e-3 / calls
    return {"busy_ms": {k: v * per_call for k, v in busy.items()},
            "idle_ms": {k: v * per_call for k, v in idle.items()},
            "busy_s": sum(busy.values()) / 1e6, "idle_s": sum(idle.values()) / 1e6}


def _idle(spans: Spans, idle: dict, a: float, b: float) -> None:
    """The idle stretch [a, b) cut at the spans' bounds, piece by piece."""
    lo = bisect.bisect_right(spans.bounds, a)
    hi = bisect.bisect_left(spans.bounds, b)
    cuts = [a, *spans.bounds[lo:hi], b]
    for x, y in zip(cuts, cuts[1:]):
        name = spans.at((x + y) / 2)
        idle[name] = idle.get(name, 0.0) + y - x


def of(run) -> dict | None:
    """The run's attribution, read from its trace file once and kept in
    ``run.probes["spans"]`` (so the run's details carry it); None without
    a traced window."""
    if "spans" not in run.probes:
        path = run.details.get("trace_file")
        if run.trace is None or path is None:
            return None
        with open(os.path.join(ROOT, path)) as f:
            data = json.load(f)
        events = data.get("traceEvents", data) if isinstance(data, dict) else data
        run.probes["spans"] = attribute(events, run.trace.calls)
    return run.probes["spans"]


def busy_ms(run, layer: str) -> float | None:
    """Device ms per call launched inside ``layer``'s span; None on a run
    with no device events or a program without the span."""
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return of(run)["busy_ms"].get(layer)


def idle_ms(run, layer: str) -> float | None:
    """Device-idle ms per call inside ``layer``'s span; None as above."""
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return of(run)["idle_ms"].get(layer)


def counts() -> dict | None:
    """The program's counters over the traced window, or None where the
    program has none."""
    try:
        from sview_fmindex_tpu_torch import tracing as program_tracing
    except ImportError:
        return None
    return dict(program_tracing.COUNTS)


def per_call(run, key: str, scale: float = 1.0) -> float | None:
    """``COUNTS[key]`` per call of the window, times ``scale``; None where
    the program's count of calls is not the window's."""
    got = counts()
    if run.trace is None or got is None or got.get("calls") != run.trace.calls:
        return None
    return got.get(key, 0) * scale / run.trace.calls
