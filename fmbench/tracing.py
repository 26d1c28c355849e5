"""Reduction of a traced window to numbers: ``torch.profiler``'s Chrome
trace of the window, read back from its file.

- The window is the span of the harness's ``fmbench.window`` annotation.
- Device activity is every event of category ``kernel``, ``gpu_memcpy`` or
  ``gpu_memset``; ``busy_s`` is the length of their union inside the window.
- An idle gap is a stretch of the window with no device activity; it is
  named by the innermost host event (an operator, a runtime call or a
  harness span) that covers its middle.
- Kernel time by name: the sum of each kernel's durations inside the window.
"""
from __future__ import annotations

import bisect
import json
import re

WINDOW = "fmbench.window"
CALL = "fmbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")
# the sort kernels of ``torch.sort`` (CUB's radix sorts and PyTorch's own
# small-segment sorts)
SORT_KERNELS = re.compile(r"RadixSort|radixSort|sortKeyValueInplace|bitonicSort|"
                          r"warpMergeSort|DeviceMergeSort|segmented_sort")
JOIN_KERNELS = re.compile(r"join_kernel")
TOP = 10


def short_name(name: str, limit: int = 160) -> str:
    """A kernel's name without ``void``, its argument list and template
    arguments nested deeper than one level (copies keep their names)."""
    if not name.startswith("void "):
        return name[:limit]
    name = name[5:].replace("(anonymous namespace)::", "")
    out, depth = [], 0
    for ch in name:
        if ch == "(" and depth == 0:
            break
        if ch == "<":
            depth += 1
            if depth > 1:
                continue
        elif ch == ">":
            depth -= 1
            if depth > 0:
                continue
        elif depth > 1:
            continue
        out.append(ch)
    short = "".join(out)
    return short if len(short) <= limit else short[:limit - 3] + "..."


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class TraceSummary:
    """What the readers take from one traced window."""

    def __init__(self, events: list, calls: int):
        win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
        if not win:
            raise ValueError(f"no {WINDOW} span in the trace")
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        self.window_s = (w1 - w0) / 1e6
        self.calls = calls
        dev = []
        self.kernel_us: dict = {}
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            dev.append((a, b))
            self.kernel_us[e["name"]] = self.kernel_us.get(e["name"], 0.0) + (b - a)
        busy = _union(dev)
        self.busy_s = sum(b - a for a, b in busy) / 1e6
        gaps, t = [], w0
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if w1 > t:
            gaps.append((t, w1))
        host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                      for e in events
                      if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                      and e.get("name") != WINDOW)
        starts = [h[0] for h in host]
        by_name: dict = {}
        for a, b in gaps:
            mid = (a + b) / 2
            # host events nest, so the latest one started that still runs
            # at the middle is the innermost
            name = "(no host event)"
            for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                if host[i][1] >= mid:
                    name = host[i][2]
                    break
            by_name[name] = by_name.get(name, 0.0) + (b - a)
        self.idle_gaps = sorted(([k, v / 1e6] for k, v in by_name.items()),
                                key=lambda x: -x[1])[:TOP]
        ops: dict = {}
        for k, v in self.kernel_us.items():
            ops[short_name(k)] = ops.get(short_name(k), 0.0) + v
        self.device_ops = sorted(([k, v / 1e6] for k, v in ops.items()), key=lambda x: -x[1])[:TOP]

    def ms_per_call(self, pattern: re.Pattern) -> float | None:
        """Device ms per call of the kernels whose name matches, or None
        where none ran."""
        us = [v for k, v in self.kernel_us.items() if pattern.search(k)]
        if not us or not self.calls:
            return None
        return sum(us) / 1e3 / self.calls

    def idle_share(self) -> float | None:
        """% of the window in which nothing ran on the device; None where
        the trace holds no device activity (a CPU run)."""
        if self.busy_s <= 0 or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)


def load(path: str, calls: int) -> TraceSummary:
    with open(path) as f:
        data = json.load(f)
    return TraceSummary(data.get("traceEvents", data) if isinstance(data, dict) else data,
                        calls)
