"""Wide (u64-position) engine throughput of the PyTorch/CUDA port on one
GPU, the counterpart of ``tools/wide_bench.py``.

Measures the wide STREAM engine (the join kernel's segmented modes over a
segment-local table plus segment bases, ``ops/wide.py``) and the wide gather
engine at a serving batch size on the headline bench's text with
``force_wide=True``: the exact int64-position code path that serves texts of
2^32 bp and more, on an index that fits one card.

Per engine: count and locate queries/s, best and worst of 3 windows on a
synchronised host clock (and from CUDA events on a card).  ``engine_for``
must name the engine asked for.  Then parity: stream == gather counts, 200
locations re-checked against the raw text, 64 counts against the host
``FmIndex``.  ``launches``: the join kernel's launches over the upload and
over one ``count`` and one ``locate`` call per engine, as ``{"mode@sigma":
n}``; on a card the stream engine's calls must have launched the segmented
rank mode, and the gather engine's calls no rank mode at all.  Prints one
JSON line; ``--out`` also writes it to a file.

Run: ``python tools/torch_wide_bench.py`` (uses the ``bench_cache`` blob;
``--device cpu`` names the CPU, and with neither a card nor that flag it
raises).  Env: BENCH_TEXT_SIZE (default 1e9), WIDE_BENCH_BATCH (default 1e5),
BENCH_CACHE_DIR.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench_torch  # noqa: E402  (numpy only at import)

SEED = bench_torch.SEED
PATTERN_LEN = bench_torch.PATTERN_LEN
WINDOWS = 3


def log(m):
    print(m, file=sys.stderr, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"wide bench check failed: {msg}")


def main(argv=None) -> dict:
    import torch

    from sview_fmindex_tpu_torch.bench.timing import device_info, force, window_rates
    from sview_fmindex_tpu_torch.models.device_index import DeviceFmIndex, resolve_device
    from sview_fmindex_tpu_torch.ops.locate import expand_capacity

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    text_size = bench_torch.settings()["text_size"]
    B = int(float(os.environ.get("WIDE_BENCH_BATCH", "100000")))
    info = device_info(device)
    log(f"[wide-bench] device: {info['smi'] or info['name']}")

    text = bench_torch.get_text(text_size)
    fm, _ = bench_torch.get_blob(text)

    t0 = time.time()
    mark = bench_torch.launch_mark()
    dev = DeviceFmIndex.from_host(fm, device, force_wide=True)
    force(dev.sa)
    upload_s = round(time.time() - t0, 3)
    launches = {"upload": bench_torch.launches_since(mark)}
    log(f"[wide-bench] wide upload (stream_rows={dev.meta.stream_rows}): {upload_s}s")
    check(dev.meta.wide_pos, "the upload is not a wide index")

    rng = np.random.default_rng(SEED + 1)
    pats_np = bench_torch.make_batch(text, rng, B)
    patterns = torch.from_numpy(pats_np).to(device)

    out = {"text_size": text_size, "batch": B, "upload_s": upload_s, "device": info}

    # warm + capacity
    counts = dev.count(patterns, use_stream=True)
    counts_np = counts.cpu().numpy()
    capacity = expand_capacity(counts_np)
    locs, pids, valid, dropped = dev.locate(patterns, capacity=capacity, use_stream=True)
    check(int(dropped[0]) == 0, "capacity overflow dropped hits")

    reps = max(8, min(32, int(4e6 // B)))
    for engine, us in (("wide-stream", True), ("wide-gather", False)):
        check(dev.engine_for(B, use_stream=us) == engine,
              f"engine_for names {dev.engine_for(B, use_stream=us)}, not {engine}")
        r = {}
        for name, fn in (
                ("count", lambda: dev.count(patterns, use_stream=us)),
                ("locate", lambda: dev.locate(patterns, capacity=capacity, use_stream=us))):
            r.update(bench_torch.rate_keys(
                name, window_rates(fn, B, reps, WINDOWS, device=device)))
            mark = bench_torch.launch_mark()
            fn()
            per_call = launches[f"{engine} {name}"] = bench_torch.launches_since(mark)
            ranked = any(k.startswith("rank_seg@") for k in per_call)
            check(device.type != "cuda" or ranked == us,
                  f"one {engine} {name} call launched {per_call}")
        out[engine] = r
        log(f"[wide-bench] {engine}: count {r['count_qps']/1e6:.3f} Mq/s (worst window "
            f"{r['count_qps_worst']/1e6:.3f}), locate {r['locate_qps']/1e6:.3f} Mq/s "
            f"(worst {r['locate_qps_worst']/1e6:.3f}), host clock")

    # parity: stream vs gather + raw-text re-check + host oracle sample
    cg = dev.count(patterns, use_stream=False)
    check(torch.equal(cg, counts), "wide stream/gather count parity FAILED")
    locs_np, pids_np, valid_np = (t.cpu().numpy() for t in (locs, pids, valid))
    check(int(valid_np.sum()) == int(counts_np.sum()), "valid slots != total count")
    for i in np.nonzero(valid_np)[0][:200]:
        loc, p = int(locs_np[i]), int(pids_np[i])
        check(bytes(text[loc:loc + PATTERN_LEN]) == bytes(pats_np[p]),
              f"location {loc} does not hold pattern {p}")
    for i in rng.integers(0, B, size=64):
        check(int(counts_np[i]) == fm.count(pats_np[i].tobytes()), f"count of pattern {i} vs host")
    out["parity"] = ("ok (stream==gather, 200 locations re-verified, "
                     "64 counts vs host oracle)")

    out["launches"] = launches
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
