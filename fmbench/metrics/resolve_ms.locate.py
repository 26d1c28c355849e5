"""Milliseconds per call of ``DeviceFmIndex.resolve_rows`` (expand the
ranges, gather the suffix array) on the pool's own ranges: the harness
calls ``pos_ranges`` on each batch, then times ``resolve_rows`` over the
pool in turn, synchronised with the device at both ends, for at least
``SPAN_S`` seconds."""
import time

SPAN_S = 0.5


def probe(run):
    import torch
    from sview_fmindex_tpu_torch.ops.locate import expand_capacity

    dev = run.dev
    cuda = run.device.type == "cuda"
    ranges = []
    for pats, lens in run.pool:
        lo, hi = dev.pos_ranges(pats, lens)
        ranges.append((lo, hi, expand_capacity((hi - lo).cpu().numpy())))
    stream = dev.engine_for(int(ranges[0][0].shape[0])).endswith("stream")
    for lo, hi, cap in ranges:
        dev.resolve_rows(lo, hi, cap, stream)
    if cuda:
        torch.cuda.synchronize(run.device)
    calls, t0 = 0, time.perf_counter()
    while True:
        for lo, hi, cap in ranges:
            dev.resolve_rows(lo, hi, cap, stream)
            calls += 1
        if cuda:
            torch.cuda.synchronize(run.device)
        if time.perf_counter() - t0 >= SPAN_S:
            break
    run.probes["resolve_ms"] = (time.perf_counter() - t0) / calls * 1e3


def read(run):
    return run.probes.get("resolve_ms")
