"""Microbenchmark suite of the PyTorch/CUDA port (port of
``sview_fmindex_tpu.bench.micro``): the criterion-analog groups, committed
and re-runnable.

- ``rank``    ns/query of the two rank engines below the query API over a
  batch-size sweep: ``gather`` (``ops.rank.rank_next``, one fused-row gather
  per position), ``stream`` (``ops.stream_join.rank_next_sorted``: sort, the
  join kernel, unsort) and ``join_only`` (the join kernel alone on keys
  sorted beforehand), so the kernel and its sort can be told apart.  The
  port's tables are untiled: there is no tile sweep.
- ``sort``    what one pass of a sorted chain pays around the kernel
  (``ops.search.sorted_pass``): the int64-key ``torch.sort`` of the
  sentinel-shifted positions plus the payload gather by its permutation
  (``sort_i64_perm``), and the sort alone (``sort_i64_only``), at N = 2B.
- ``search``  count throughput per engine and batch size: the gather
  against the stream engine per B is the crossover measurement behind
  ``DeviceFmIndex.STREAM_MIN_BATCH`` (:func:`crossover_table`).
- ``locate``  phase breakdown: ranges / resolve / whole pipeline, per engine
  and batch size.
- ``build``   host build, blob load from memory and through ``np.memmap``,
  device upload and its phases.

Run: ``python -m sview_fmindex_tpu_torch.bench.micro --text-size 1e7``.
Writes one JSON with every row (``--out``); prints an aligned table on
stderr and, as the last line of stdout, ``{"metric": "micro_rows", ...}``.

Runs on the current CUDA device (CUDA events around back-to-back calls, the
first call apart as ``warm_s``); ``--device cpu`` runs the plain versions on
the CPU on the host clock, at sizes that default smaller.  With no CUDA
device and no ``--device`` it raises.  On a card every timed call of the
stream rows launches the join kernel once: the suite checks that
``ops.stream_join.LAUNCHES["rank"]`` rose by exactly the number of calls it
made in the ``rank`` group, and reports the launches per group.  Once per B,
outside the timed loops, the ``rank`` group holds the three rows' answers
against each other and the join kernel against ``join_plain`` on the same
keys: a difference fails the run, on the card as on the CPU.  The dense seed
table is the headline bench's on a card (``dense_lut_entries=1<<28``), so
the crossover table describes the index the main path serves.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

BENCH_SEED = 42  # the headline bench's text seed: its cached blob is this suite's too


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def build_index(text_size: int, seed: int, cache_dir: str | None):
    """(text uint8 [n], host FmIndex, build seconds, blob path or None).
    With ``cache_dir`` the blob is cached as ``micro_<n>_<seed>.blob``; at
    seed 42 the headline bench's ``index_<n>_42_b3u64_r2_k3.blob`` (the same
    generator and configuration, so the same bytes) is read where it exists."""
    from .. import (
        BLOCK3_U64,
        EncodingTable,
        FmIndex,
        FmIndexBuilder,
        LookupTableConfig,
        SuffixArrayConfig,
    )

    rng = np.random.default_rng(seed)
    text = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=text_size)]
    blob_path = None
    candidates = []
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        blob_path = os.path.join(cache_dir, f"micro_{text_size}_{seed}.blob")
        candidates.append(blob_path)
        if seed == BENCH_SEED:
            candidates.append(os.path.join(
                cache_dir, f"index_{text_size}_{seed}_b3u64_r2_k3.blob"))
    hit = next((p for p in candidates if os.path.exists(p)), None)
    build_s = 0.0
    if hit:
        blob_path = hit
        blob = np.fromfile(hit, np.uint8)
    else:
        enc = EncodingTable.from_symbols([b"A", b"C", b"G", b"T"])
        builder = FmIndexBuilder(
            text_size, enc.symbol_count(), enc, position="u32", block=BLOCK3_U64,
            suffix_array_config=SuffixArrayConfig.compressed(2),
            lookup_table_config=LookupTableConfig.kmer_size(3))
        t0 = time.perf_counter()
        blob = np.frombuffer(bytes(builder.build(text.tobytes())), np.uint8)
        build_s = time.perf_counter() - t0
        if blob_path:
            blob.tofile(blob_path)
    fm = FmIndex.load(blob, position="u32", block=BLOCK3_U64, encoder_kind="table")
    return text, fm, build_s, blob_path


def make_patterns(text: np.ndarray, n: int, length: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(text) - length, size=n)
    return text[starts[:, None] + np.arange(length)]


def crossover_table(rows: list) -> list[str]:
    """The ``search`` rows as the crossover table: per B the gather and the
    stream engine's ns/query and which is ahead."""
    by_b: dict = {}
    for r in rows:
        if r["group"] == "search":
            by_b.setdefault(r["B"], {})[r["name"]] = r["value"]
    lines = [f"{'B':>9s} {'count[gather] ns/q':>19s} {'count[stream] ns/q':>19s}  ahead"]
    for B in sorted(by_b):
        g, s = by_b[B].get("count[gather]"), by_b[B].get("count[stream]")
        if g is None or s is None:
            continue
        lines.append(f"{B:>9d} {g:>19.2f} {s:>19.2f}  "
                     f"{'stream' if s < g else 'gather'} x{max(g, s) / max(min(g, s), 1e-9):.2f}")
    return lines


def main(argv=None, keep_answers: bool = False) -> dict:
    """Run the suite; returns the report (device, text_size, rows, launches
    per group, and with ``keep_answers`` the patterns, counts and ranges each
    engine returned inside the groups, as numpy)."""
    import torch

    from ..models.device_index import resolve_device
    from ..ops import rank as rank_ops
    from ..ops import stream_join
    from ..ops.locate import expand_capacity
    from .timing import force, timeit

    ap = argparse.ArgumentParser(prog="micro")
    ap.add_argument("--text-size", type=float, default=None)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--batches", default=None,
                    help="comma-separated batch sizes (default per device)")
    ap.add_argument("--groups", default="rank,sort,search,locate,build")
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--out", default=None, help="write rows as JSON")
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device; 'cpu' "
                         "runs the plain versions on the host clock)")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of one locate there")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    text_size = int(args.text_size or (1e8 if on_card else 1e6))
    batches = [int(float(b)) for b in (
        args.batches.split(",") if args.batches
        else (["100000", "1000000"] if on_card else ["20000"]))]
    groups = set(args.groups.split(","))
    rows: list[dict] = []
    launches: dict = {}
    answers: dict = {B: {} for B in batches}
    calls = [0]  # timed calls since the last reset, warm calls included

    def timed(fn, *a):
        calls[0] += 1 + args.reps
        return timeit(fn, *a, reps=args.reps, device=device)

    def row(group, name, B, steady_s, warm_s, unit="ns/q", n=None):
        n = n if n is not None else B
        val = steady_s / max(n, 1) * 1e9 if unit == "ns/q" else steady_s
        rows.append(dict(group=group, name=name, B=B, value=round(val, 2), unit=unit,
                         steady_ms=round(steady_s * 1e3, 3), warm_s=round(warm_s, 2)))
        log(f"  {group:7s} {name:34s} B={B:<9d} {val:10.2f} {unit:6s} "
            f"(steady {steady_s*1e3:8.2f} ms, warm {warm_s:5.1f} s)")

    def to_np(x):
        return tuple(t.cpu().numpy() for t in x) if isinstance(x, tuple) else x.cpu().numpy()

    log(f"[micro] device={name} text_size={text_size}")
    t0 = time.perf_counter()
    text, fm, build_s, blob_path = build_index(text_size, args.seed, args.cache_dir)
    log(f"[micro] host build: {build_s:.1f}s (+load {time.perf_counter()-t0-build_s:.1f}s)")

    t0 = time.perf_counter()
    # the headline bench's seed table on a card (shallow host part: the
    # levels above 2^20 entries extend on the device); a small one on the CPU
    dev = fm.to_device(device, dense_lut_entries=1 << 28 if on_card else 1 << 16,
                       dense_host_entries=1 << 20, sa_full="device")
    force(dev.fused)
    upload_s = time.perf_counter() - t0
    log(f"[micro] device upload: {upload_s:.1f}s (dense_k={dev.meta.dense_k})")
    if "build" in groups:
        from .. import BLOCK3_U64, FmIndex

        def build_row(name, value):
            rows.append(dict(group="build", name=name, B=text_size,
                             value=round(value, 4), unit="s"))
            log(f"  build   {name:34s} B={text_size:<9d} {value:10.4f} s")

        build_row("host_build", build_s)
        if blob_path:
            for how, read in (("memory", lambda: np.fromfile(blob_path, np.uint8)),
                              ("mmap", lambda: np.memmap(blob_path, np.uint8, mode="r"))):
                t0 = time.perf_counter()
                FmIndex.load(read(), position="u32", block=BLOCK3_U64, encoder_kind="table")
                build_row(f"blob_load[{how}]", time.perf_counter() - t0)
        build_row("device_upload", upload_s)
        for phase, secs in dev.upload_phases.items():
            build_row(f"upload[{phase}]", secs)

    sigma = dev.meta.sigma
    sentinel = dev.sentinel
    rng = np.random.default_rng(args.seed + 7)

    def rank_inputs(B):
        N = 2 * B  # a search step ranks both range endpoints
        pos = torch.from_numpy(rng.integers(0, fm.text_len, N)).to(device)
        sym = torch.from_numpy(rng.integers(0, sigma, N)).to(device)
        return N, pos, sym

    if "rank" in groups:
        log("[micro] group rank")
        before = stream_join.LAUNCHES["rank"]
        calls[0] = 0
        for B in batches:
            N, pos, sym = rank_inputs(B)
            warm, dt = timeit(lambda p, s: rank_ops.rank_next(dev.meta, dev.fused, sentinel, p, s),
                              pos, sym, reps=args.reps, device=device)
            row("rank", "gather", B, dt, warm, n=N)
            if dev.meta.stream_rows:
                warm, dt = timed(lambda p, s: stream_join.rank_next_sorted(
                    dev.stream_tbl, sentinel, p, s, sigma), pos, sym)
                row("rank", "stream", B, dt, warm, n=N)
                key, perm = torch.sort(pos + (pos < sentinel).long())
                payload = sym[perm].contiguous()
                warm, dt = timed(lambda k, c: stream_join.join(
                    dev.stream_tbl, k, c, sigma, False), key, payload)
                row("rank", "join_only", B, dt, warm, n=N)
                # the rows' answers, outside the timed loops: both engines and
                # the kernel alone agree, and the kernel equals its plain version
                want = rank_ops.rank_next(dev.meta, dev.fused, sentinel, pos, sym)
                got = stream_join.rank_next_sorted(dev.stream_tbl, sentinel, pos, sym, sigma)
                alone = stream_join.join(dev.stream_tbl, key, payload, sigma, False)[0]
                plain = stream_join.join_plain(dev.stream_tbl, key, payload, sigma, False)[0]
                calls[0] += 2
                if not (torch.equal(got, want) and torch.equal(alone, want[perm])
                        and torch.equal(alone, plain)):
                    raise RuntimeError(f"rank group, B={B}: the stream engine, the join "
                                       f"kernel, its plain version and the gather engine "
                                       f"do not agree")
                if keep_answers:
                    answers[B]["rank[gather]"] = to_np(want)
                    answers[B]["rank[stream]"] = to_np(got)
        launches["rank"] = stream_join.LAUNCHES["rank"] - before
        if on_card and launches["rank"] != calls[0]:
            raise RuntimeError(f"rank group: {calls[0]} stream calls, but the join kernel's "
                               f"rank mode was launched {launches['rank']} times")

    if "sort" in groups:
        log("[micro] group sort")
        for B in batches:
            N, pos, _ = rank_inputs(B)
            lane = torch.arange(N, device=device)

            def sort_perm(p, l):
                key, perm = torch.sort(p + (p < sentinel).long())
                return key, l[perm]

            warm, dt = timeit(sort_perm, pos, lane, reps=args.reps, device=device)
            row("sort", "sort_i64_perm", B, dt, warm, n=N)
            warm, dt = timeit(lambda p: torch.sort(p), pos, reps=args.reps, device=device)
            row("sort", "sort_i64_only", B, dt, warm, n=N)

    pats = {B: torch.from_numpy(np.ascontiguousarray(
        make_patterns(text, B, 20, args.seed + 1))).to(device) for B in batches}
    engines = [(False, "gather")] + ([(True, "stream")] if dev.meta.stream_rows else [])
    if keep_answers:
        for B in batches:
            answers[B]["patterns"] = pats[B].cpu().numpy()

    if "search" in groups:
        log("[micro] group search")
        before = stream_join.LAUNCHES["rank"]
        for B in batches:
            for us, eng in engines:
                warm, dt = timeit(lambda p, us=us: dev.count(p, None, use_stream=us),
                                  pats[B], reps=args.reps, device=device)
                row("search", f"count[{eng}]", B, dt, warm)
                if keep_answers:
                    answers[B][f"count[{eng}]"] = to_np(dev.count(pats[B], None, use_stream=us))
        launches["search"] = stream_join.LAUNCHES["rank"] - before
        for line in crossover_table(rows):
            log("  " + line)

    if "locate" in groups:
        log("[micro] group locate")
        before = sum(stream_join.LAUNCHES.values())
        for B in batches:
            cap = expand_capacity(dev.count(pats[B], None).cpu().numpy())
            for us, eng in engines:
                warm, dt = timeit(lambda p, us=us: dev.pos_ranges(p, None, use_stream=us),
                                  pats[B], reps=args.reps, device=device)
                row("locate", f"ranges[{eng}]", B, dt, warm)
                if keep_answers:
                    answers[B][f"ranges[{eng}]"] = to_np(
                        dev.pos_ranges(pats[B], None, use_stream=us))
            lo, hi = dev.pos_ranges(pats[B], None)
            warm, dt = timeit(lambda l, h: dev.resolve_rows(l, h, cap), lo, hi,
                              reps=args.reps, device=device)
            row("locate", f"resolve[cap={cap}]", B, dt, warm)
            for us, eng in engines:
                warm, dt = timeit(
                    lambda p, us=us: dev.locate_with_counts(p, None, capacity=cap, use_stream=us),
                    pats[B], reps=args.reps, device=device)
                row("locate", f"locate[{eng},cap={cap}]", B, dt, warm)
                if keep_answers:
                    answers[B][f"locate[{eng}]"] = to_np(tuple(dev.locate_with_counts(
                        pats[B], None, capacity=cap, use_stream=us)))
        launches["locate"] = sum(stream_join.LAUNCHES.values()) - before
        if args.profile_dir:
            # captured OUTSIDE the timed loops: profiling adds per-launch
            # overhead that would distort the rows above
            from torch.profiler import ProfilerActivity, profile

            B = batches[-1]
            cap = expand_capacity(dev.count(pats[B], None).cpu().numpy())
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
            with profile(activities=acts) as prof:
                force(dev.locate_with_counts(pats[B], None, capacity=cap, use_stream=True))
            os.makedirs(args.profile_dir, exist_ok=True)
            trace = os.path.join(args.profile_dir, f"locate_B{B}.json")
            prof.export_chrome_trace(trace)
            log(f"[micro] trace written to {trace}")

    report = dict(device=name, text_size=text_size, dense_k=dev.meta.dense_k, rows=rows,
                  launches=launches)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        log(f"[micro] wrote {args.out}")
    if keep_answers:
        report["answers"] = answers
    print(json.dumps(dict(metric="micro_rows", value=len(rows), unit="rows")), flush=True)
    return report


if __name__ == "__main__":
    main()
