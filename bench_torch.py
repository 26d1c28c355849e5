"""Headline benchmark of the PyTorch/CUDA port: locate queries/s on one GPU,
the counterpart of ``bench.py`` on ``sview_fmindex_tpu_torch``.

Methodology as the reference's (``bench/run_benchmark.sh``, BASELINE.md):
random nucleotide text (seed 42), 20 bp patterns cut from the text, all
unique draws, index = u32 positions / Block3<u64> / SA sampling 2 / k-mer
LUT 3, uploaded with ``to_device_torch(fm, dense_lut_entries=1<<28,
dense_host_entries=1<<20, sa_full="device", sa_fill_ratio=4)``.

Baseline anchor (BASELINE.md): ~2.3e5 locate/s on one Xeon core, in memory.

Prints ONE JSON line on stdout: {"metric", "value", "unit", "vs_baseline",
...extras}; progress goes to stderr.

- The pair-stream engine (``use_stream=True``) serves the timed runs of
  ``count`` and ``locate_with_counts``.  Before anything is printed, for
  EVERY batch: ``dropped == 0``, 200 located positions are compared with the
  raw text, and the same batch goes through the gather engine, which must
  agree exactly (the parity gate).  Any mismatch aborts the run.
- Both B=100k (the reference's largest pattern count) and B=1M are measured;
  the headline is the best locate rate, with every per-B number in the JSON.
- A rate is ``reps`` back-to-back calls over the time of the window, after
  one warm call that is in no window.  Each window is read on two clocks: a
  host clock synchronised with the device before it starts and before it
  stops (``*_qps``: what a caller feels, the numbers of the JSON's headline)
  and CUDA events (``*_qps_events``).  Five windows; the best AND the worst
  (``*_worst``) are reported, since the best alone is biased upward and the
  rate moves with the host.
- ``upload_phases``: seconds per upload phase; ``first_query_s``: process
  start to the first locate result; ``device``: the card's name and power
  limit as ``nvidia-smi --query-gpu=name,power.limit`` prints them.
- ``launches``: what this run's join-kernel launch counters read, as
  ``{"mode@sigma": n}``: over the upload, and per batch over ONE ``count``
  and ONE ``locate_with_counts`` call (all empty on the CPU, where the plain
  version serves).  On a card the run fails if a timed call launched no
  rank-mode kernel: a bench that quietly served from the gather engine would
  report another engine's rate.
- Text and blob are cached under ``BENCH_CACHE_DIR`` with ``bench.py``'s
  file names (the two builders write byte-identical blobs, so the cache is
  shared); ``build_s`` is 0 on a cache hit.

Runs on the current CUDA device; ``--device cpu`` runs the same program on
the CPU (the join kernel's plain version; for tests, its rates are not the
card's).  With no CUDA device and no ``--device`` it raises.

Env knobs (read when ``main`` runs):
  BENCH_TEXT_SIZE      text length (default 1e9)
  BENCH_PATTERN_COUNT  headline pattern count (default 100_000)
  BENCH_BIG_BATCH      large batch size (default 1_000_000; 0 disables)
  BENCH_CACHE_DIR      text and blob cache (default ./bench_cache)
  BENCH_PARITY=0       skip the gather-engine parity gate (debug only)
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

T_START = time.time()
REPO = os.path.dirname(os.path.abspath(__file__))
PATTERN_LEN = 20
SEED = 42
BASELINE_LOCATE_QPS = 2.3e5  # BASELINE.md derived anchor
N_RECHECK = 200
WINDOWS = 5
# texts up to this size come from one draw, larger ones in chunks (get_text)
TEXT_ONE_DRAW = 2**31
TEXT_CHUNK = 1 << 28
# the headline upload (bench.py:148)
UPLOAD_KW = dict(dense_lut_entries=1 << 28, dense_host_entries=1 << 20,
                 sa_full="device", sa_fill_ratio=4)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"bench check failed: {msg}")


def settings() -> dict:
    env = os.environ
    return dict(
        text_size=int(float(env.get("BENCH_TEXT_SIZE", "1e9"))),
        pattern_count=int(float(env.get("BENCH_PATTERN_COUNT", "1e5"))),
        big_batch=int(float(env.get("BENCH_BIG_BATCH", "1e6"))),
        cache_dir=env.get("BENCH_CACHE_DIR", os.path.join(REPO, "bench_cache")),
        parity=env.get("BENCH_PARITY", "1") != "0")


def cache_dir() -> str:
    return settings()["cache_dir"]


def text_path(text_size: int, cache: str | None = None) -> str:
    return os.path.join(cache or cache_dir(), f"text_{text_size}_{SEED}.bin")


def blob_path(text_size: int, cache: str | None = None) -> str:
    return os.path.join(cache or cache_dir(), f"index_{text_size}_{SEED}_b3u64_r2_k3.blob")


def get_text(text_size: int, cache: str | None = None) -> np.ndarray:
    """uint8 [text_size] seed-42 ACGT text, a read-only memmap of the cached
    file (only the pattern windows and re-checked locations page in).  Up to
    ``TEXT_ONE_DRAW`` bp in one draw (the bytes every cached text of that
    size holds), larger texts in ``TEXT_CHUNK``-byte draws of uint8, so the
    host never holds more than a chunk of int64.  ``chip_smoke.py`` writes
    its texts here too: one name, one set of bytes."""
    path = text_path(text_size, cache)
    if not os.path.exists(path):
        rng = np.random.default_rng(SEED)
        acgt = np.frombuffer(b"ACGT", np.uint8)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        if text_size <= TEXT_ONE_DRAW:
            acgt[rng.integers(0, 4, size=text_size)].tofile(tmp)
        else:
            with open(tmp, "wb") as f:
                for a in range(0, text_size, TEXT_CHUNK):
                    acgt[rng.integers(0, 4, size=min(TEXT_CHUNK, text_size - a),
                                      dtype=np.uint8)].tofile(f)
        os.replace(tmp, path)
    return np.memmap(path, dtype=np.uint8, mode="r")


def get_blob(text: np.ndarray, cache: str | None = None):
    """(host FmIndex over the cached blob, build seconds; 0.0 on a cache hit)."""
    import sview_fmindex_tpu_torch as ft

    path = blob_path(len(text), cache)
    build_s = 0.0
    if not os.path.exists(path):
        enc = ft.EncodingTable.from_symbols([b"A", b"C", b"G", b"T"])
        builder = ft.FmIndexBuilder(
            len(text), enc.symbol_count(), enc, position="u32", block=ft.BLOCK3_U64,
            suffix_array_config=ft.SuffixArrayConfig.compressed(2),
            lookup_table_config=ft.LookupTableConfig.kmer_size(3))
        t0 = time.time()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        # built straight into the file: no second copy of the blob in memory
        out = np.memmap(tmp, dtype=np.uint8, mode="w+", shape=(builder.blob_size(),))
        builder.build(text, blob=out)
        out.flush()
        del out
        os.replace(tmp, path)
        build_s = time.time() - t0
        log(f"[bench] built index for {len(text)} bp in {build_s:.1f}s "
            f"({os.path.getsize(path) / 2**20:.0f} MiB); cached")
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    return ft.FmIndex.load(mm, position="u32", block=ft.BLOCK3_U64,
                           encoder_kind="table"), build_s


def upload(fm, device=None):
    """The headline upload to ``device`` (None: the current CUDA device)."""
    import sview_fmindex_tpu_torch as ft

    return ft.to_device_torch(fm, device, **UPLOAD_KW)


def make_batch(text: np.ndarray, rng, B: int) -> np.ndarray:
    """B uniform 20-bp windows of the text, uint8 [B, 20]."""
    starts = rng.integers(0, len(text) - PATTERN_LEN, size=B)
    return np.ascontiguousarray(text[starts[:, None] + np.arange(PATTERN_LEN)])


def rate_keys(name: str, w: dict) -> dict:
    """The four numbers kept of one ``timing.window_rates`` result: best and
    worst window on the host clock, and from CUDA events (None on the CPU)."""
    ev = w["events"]
    return {f"{name}_qps": max(w["host"]), f"{name}_qps_worst": min(w["host"]),
            f"{name}_qps_events": max(ev) if ev else None,
            f"{name}_qps_events_worst": min(ev) if ev else None}


def launches_since(before) -> dict:
    """The join-kernel launches since ``before`` (a copy of
    ``ops.stream_join.LAUNCHES_BY_SIGMA``), as ``{"mode@sigma": n}``."""
    from sview_fmindex_tpu_torch.ops import stream_join

    now = stream_join.LAUNCHES_BY_SIGMA
    return {f"{mode}@{sigma}": now[mode, sigma] - before[mode, sigma]
            for mode, sigma in sorted(now) if now[mode, sigma] > before[mode, sigma]}


def launch_mark():
    """A copy of the launch counters, for :func:`launches_since`."""
    from sview_fmindex_tpu_torch.ops import stream_join

    return stream_join.LAUNCHES_BY_SIGMA.copy()


def run(device=None) -> dict:
    import torch

    from sview_fmindex_tpu_torch.bench.timing import device_info, force, window_rates
    from sview_fmindex_tpu_torch.models.device_index import resolve_device
    from sview_fmindex_tpu_torch.ops.locate import expand_capacity

    cfg = settings()
    text_size = cfg["text_size"]
    device = resolve_device(device)
    info = device_info(device)
    log(f"[bench] device: {info['smi'] or info['name']}")

    text = get_text(text_size, cfg["cache_dir"])
    t0 = time.time()
    fm, build_s = get_blob(text, cfg["cache_dir"])
    log(f"[bench] blob load: {time.time() - t0:.2f}s (build_s={build_s:.1f})")

    t0 = time.time()
    mark = launch_mark()
    dev = upload(fm, device)
    force(dev.fused)
    upload_s = time.time() - t0
    launches = {"upload": launches_since(mark)}
    log(f"[bench] device upload (dense_k={dev.meta.dense_k}, "
        f"sa_full={dev.meta.has_sa_full}, pair={dev.meta.pair_rows > 0}): {upload_s:.2f}s")

    rng = np.random.default_rng(SEED + 1)
    results = {}
    first_query_s = None
    batches = [cfg["pattern_count"]] + ([cfg["big_batch"]] if cfg["big_batch"] else [])
    for B in batches:
        reps = max(8, min(32, int(4e6 // B)))
        patterns_np = make_batch(text, rng, B)
        patterns = torch.from_numpy(patterns_np).to(device)
        r = {}

        # ---- first calls (the kernel library loads here on a card) ----
        t0 = time.time()
        counts = dev.count(patterns, use_stream=True)
        counts_np = counts.cpu().numpy()
        capacity = expand_capacity(counts_np)
        out = dev.locate_with_counts(patterns, capacity=capacity, use_stream=True)
        force(out)
        r["warmup_s"] = round(time.time() - t0, 3)
        if first_query_s is None:
            first_query_s = round(time.time() - T_START, 3)
        check(bool((counts_np >= 1).all()), "a pattern cut from the text has count 0")
        total = int(counts_np.sum())

        # ---- steady state: best and worst of 5 windows, two clocks ----
        for name, fn in (
                ("count", lambda: dev.count(patterns, use_stream=True)),
                ("locate", lambda: dev.locate_with_counts(
                    patterns, capacity=capacity, use_stream=True))):
            r.update(rate_keys(name, window_rates(fn, B, reps, WINDOWS, device=device)))
        r["hits"] = total
        r["capacity"] = capacity
        # one call of each, counted: the timed calls are these calls
        per_call = {}
        for name, fn in (("count", lambda: dev.count(patterns, use_stream=True)),
                         ("locate", lambda: dev.locate_with_counts(
                             patterns, capacity=capacity, use_stream=True))):
            mark = launch_mark()
            fn()
            per_call[name] = launches_since(mark)
            check(device.type != "cuda" or any(k.startswith("rank@") for k in per_call[name]),
                  f"B={B}: a {name} call launched no rank-mode join kernel: {per_call[name]}")
        launches[str(B)] = per_call
        log(f"[bench] B={B}: count {r['count_qps'] / 1e6:.3f} Mq/s (worst window "
            f"{r['count_qps_worst'] / 1e6:.3f}), locate {r['locate_qps'] / 1e6:.3f} Mq/s "
            f"(worst {r['locate_qps_worst'] / 1e6:.3f}), host clock"
            + (f"; CUDA events count {r['count_qps_events'] / 1e6:.3f}-"
               f"{r['count_qps_events_worst'] / 1e6:.3f}, locate "
               f"{r['locate_qps_events'] / 1e6:.3f}-{r['locate_qps_events_worst'] / 1e6:.3f}"
               if r["count_qps_events"] else "")
            + f" ({total} hits, cap {capacity}, first calls {r['warmup_s']}s)")

        # ---- correctness: every reported location matches its pattern ----
        locs, pids, valid, counts2, dropped = dev.locate_with_counts(
            patterns, capacity=capacity, use_stream=True)
        check(int(dropped[0]) == 0, "capacity overflow dropped hits")
        check(torch.equal(counts2, counts), "locate_with_counts counts != count")
        check(int(valid.sum()) == total, "valid slots != total count")
        locs_np, pids_np, valid_np = (t.cpu().numpy() for t in (locs, pids, valid))
        for i in np.nonzero(valid_np)[0][:N_RECHECK]:
            loc, p = int(locs_np[i]), int(pids_np[i])
            check(0 <= loc <= text_size - PATTERN_LEN
                  and bytes(text[loc:loc + PATTERN_LEN]) == bytes(patterns_np[p]),
                  f"location {loc} does not hold pattern {p}")

        # ---- parity gate: stream vs gather engines, EVERY measured batch ----
        if cfg["parity"]:
            t0 = time.time()
            c_g = dev.count(patterns, use_stream=False, use_pair=False)
            check(torch.equal(c_g, counts), "count parity FAILED (stream vs gather)")
            lg, pg, vg, _, _ = dev.locate_with_counts(
                patterns, capacity=capacity, use_stream=False, use_pair=False)
            check(torch.equal(vg, valid) and torch.equal(lg[vg], locs[valid])
                  and torch.equal(pg[vg], pids[valid]),
                  "locate parity FAILED (stream vs gather)")
            log(f"[bench] parity gate B={B} (both engines): OK ({time.time() - t0:.1f}s)")
        results[B] = r

    headline_B = max(results, key=lambda b: results[b]["locate_qps"])
    head = results[headline_B]
    return {
        "metric": "locate_queries_per_sec_per_chip",
        "value": head["locate_qps"],
        "value_worst": head["locate_qps_worst"],
        "unit": "queries/s",
        "vs_baseline": round(head["locate_qps"] / BASELINE_LOCATE_QPS, 2),
        "count_qps": head["count_qps"],
        "count_qps_worst": head["count_qps_worst"],
        "headline_batch": headline_B,
        "text_size": text_size,
        "batches": {str(b): r for b, r in results.items()},
        "build_s": round(build_s, 1),
        "upload_s": round(upload_s, 3),
        "upload_phases": {k: round(v, 3) for k, v in dev.upload_phases.items()},
        "first_query_s": first_query_s,
        "launches": launches,
        "device": info,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device; 'cpu' "
                         "runs the plain versions on the CPU)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device)), flush=True)


if __name__ == "__main__":
    main()
