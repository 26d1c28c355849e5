#!/usr/bin/env python3
"""Scale acceptance for the port's wide (u64) path: a real index above 2^32 bp
served range-sharded (``RangeShardedFmIndex``) and bit-exact against the host
oracle.  The PyTorch port's counterpart of ``tools/wide_scale_check.py``, with
its flags and JSON keys.

Prereq: a text and its u64 blob (BLOCK3_U64, table encoder), e.g. the pair
that ``SMOKE_WIDE_TEXT_SIZE=4.5e9 python3 chip_smoke.py`` builds and caches
under ``bench_cache/``.  Run:

    python3 tools/torch_wide_scale_check.py \\
        --text bench_cache/text_4500000000_42.bin \\
        --blob bench_cache/index_4500000000_42_u64_b3u64_r2_k3.blob \\
        --out wide_scale.json

By default the index is served by one NCCL rank on the card, in this process;
``--ranks 2`` runs two gloo ranks as child processes on ``cuda:0`` through the
process harness of ``bench/scaling.py``.  On the card the text must be 2^32 bp
or longer.  ``--device cpu`` runs the ranks on the CPU (the tests): there a
shorter text (a u64 or u32 blob) is served through ``force_wide=True``.

Half the pattern starts lie above 2^32 where the text reaches past it.
Counts and sorted location sets are compared with the host ``FmIndex``,
pattern by pattern.  ``ok`` needs 0 mismatches and, for a text of 2^32 bp or
more, at least one location at or above 2^32.  Besides the JAX tool's keys the
JSON carries the card's ``nvidia-smi`` name and power limit, each rank's
``all_reduce`` calls, bytes and share of a locate call (``range_shard.STATS``,
from a second call with the collectives timed) and, under ``answers``, the
pattern starts with their counts and locations; what it prints leaves the
answers out.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

GROUP_TIMEOUT = 600  # seconds, every collective; staging a rank takes minutes at 4.5e9


def load_index(blob_path: str):
    """The host ``FmIndex`` of a BLOCK3_U64, table-encoded blob: u64
    positions, or u32 for a text under 2^32 bp."""
    import sview_fmindex_tpu_torch as ft

    mm = np.memmap(blob_path, dtype=np.uint8, mode="r")
    try:
        return ft.FmIndex.load(mm, position="u64", block=ft.BLOCK3_U64, encoder_kind="table")
    except ft.LoadError:
        return ft.FmIndex.load(mm, position="u32", block=ft.BLOCK3_U64, encoder_kind="table")


def draw_patterns(text: np.ndarray, count: int, plen: int, seed: int):
    """(starts int64 [count], patterns uint8 [count, plen]): where the text
    reaches past 2^32, the second half of the starts lies above it."""
    rng = np.random.default_rng(seed)
    n = text.shape[0]
    if n - plen > 2**32:
        starts = np.concatenate([rng.integers(0, n - plen, size=count // 2),
                                 rng.integers(2**32, n - plen, size=count - count // 2)])
    else:
        starts = rng.integers(0, n - plen, size=count)
    return starts, np.ascontiguousarray(text[starts[:, None] + np.arange(plen)])


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rank(workdir: str, world: int, rank: int, device: str | None) -> dict:
    """One rank: join the group, stage this rank's block range of the blob,
    answer the batch, then time one more locate with its collectives
    synchronised.  Rank 0 also returns the answers."""
    from sview_fmindex_tpu_torch.bench.scaling import _fresh_store
    from sview_fmindex_tpu_torch.parallel import distributed, range_shard
    from sview_fmindex_tpu_torch.parallel.mesh import make_mesh

    with open(os.path.join(workdir, "job.json")) as f:
        job = json.load(f)
    rt = distributed.initialize(f"file://{_fresh_store(workdir, world, rank)}", world, rank,
                                device=device, timeout=GROUP_TIMEOUT)
    try:
        fm = load_index(job["blob"])
        pats = np.load(os.path.join(workdir, "patterns.npy"))
        lens = np.full(pats.shape[0], pats.shape[1], np.int32)
        rss_before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        t0 = time.perf_counter()
        rs = range_shard.RangeShardedFmIndex(fm, make_mesh(axis="rs"),
                                             force_wide=job["force_wide"], dense_entries=0)
        _sync(rt.device)
        shard_s = time.perf_counter() - t0
        rss_after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        if not rs.meta.wide_pos:
            raise RuntimeError("the range-sharded index is not wide")
        t0 = time.perf_counter()
        counts = rs.count(pats, lens)
        locs, pids, valid, dropped = rs.locate(pats, lens)
        _sync(rt.device)
        query_s = time.perf_counter() - t0
        for k in range_shard.STATS:
            range_shard.STATS[k] = 0
        range_shard.TIME_COLLECTIVES = True
        try:
            t0 = time.perf_counter()
            rs.locate(pats, lens)
            _sync(rt.device)
            locate_s = time.perf_counter() - t0
        finally:
            range_shard.TIME_COLLECTIVES = False
        st = dict(range_shard.STATS)
        out = {"rank": rank, "backend": rt.backend, "device": str(rt.device),
               "shard_s": shard_s, "query_s": query_s, "shard_rss_before_kb": rss_before,
               "shard_rss_after_kb": rss_after, "fused_rows": int(rs.fused.shape[0]),
               "sa_entries": int(rs.sa.shape[0]),
               "all_reduce_calls": st["all_reduce_calls"],
               "all_reduce_bytes": st["all_reduce_bytes"],
               "all_reduce_s": st["all_reduce_seconds"], "locate_s": locate_s,
               "all_reduce_share": st["all_reduce_seconds"] / locate_s}
        if rank == 0:
            valid = valid.cpu().numpy()
            by = [[] for _ in range(pats.shape[0])]
            for loc, p in zip(locs.cpu().numpy()[valid], pids.cpu().numpy()[valid]):
                by[int(p)].append(int(loc))
            out.update(counts=counts.cpu().numpy().tolist(), locations=[sorted(b) for b in by],
                       dropped=int(dropped.sum()))
        return out
    finally:
        distributed.shutdown()


def run(text_path: str, blob_path: str, patterns: int = 256, plen: int = 20, seed: int = 123,
        ranks: int = 1, device: str | None = None) -> dict:
    """The check; returns the report (``answers`` included)."""
    from sview_fmindex_tpu_torch.bench import scaling
    from sview_fmindex_tpu_torch.bench.timing import device_info
    from sview_fmindex_tpu_torch.models.device_index import resolve_device

    dev = resolve_device(device)  # raises without a card unless the CPU is named
    t0 = time.perf_counter()
    text = np.memmap(text_path, dtype=np.uint8, mode="r")
    n = text.shape[0]
    if dev.type == "cuda" and n < 2**32:
        raise ValueError(f"on the card the text must be 2^32 bp or longer (got {n})")
    fm = load_index(blob_path)
    if fm.text_len != n:
        raise ValueError(f"the blob indexes {fm.text_len} bp, the text has {n}")
    print(f"[wide] blob mapped in {time.perf_counter() - t0:.1f} s; n={n}", file=sys.stderr,
          flush=True)
    starts, pats = draw_patterns(text, patterns, plen, seed)
    with tempfile.TemporaryDirectory(prefix="sview_wide_scale_") as work:
        np.save(os.path.join(work, "patterns.npy"), pats)
        with open(os.path.join(work, "job.json"), "w") as f:
            json.dump({"blob": os.path.abspath(blob_path), "force_wide": n < 2**32}, f)
        if ranks == 1:
            res = [_rank(work, 1, 0, device)]
        else:
            res = scaling._spawn(work, ranks, device,
                                 entry=[sys.executable, os.path.abspath(__file__), "rank"])
    r0 = res[0]
    if r0["dropped"]:
        raise RuntimeError(f"{r0['dropped']} hits dropped at the auto-sized capacity")
    t0 = time.perf_counter()
    mismatches = checked = 0
    for i in range(patterns):
        pat = pats[i].tobytes()
        want_l = sorted(int(x) for x in fm.locate(pat))
        checked += len(want_l)
        if r0["counts"][i] != fm.count(pat) or r0["locations"][i] != want_l:
            mismatches += 1
            print(f"MISMATCH pattern {i}: count {r0['counts'][i]} vs {fm.count(pat)}; "
                  f"{r0['locations'][i][:4]} vs {want_l[:4]}", file=sys.stderr, flush=True)
    oracle_s = time.perf_counter() - t0
    hi_hits = sum(loc >= 2**32 for locs in r0["locations"] for loc in locs)
    print(f"[wide] {patterns} patterns, {checked} locations, {hi_hits} above 2^32, "
          f"{mismatches} mismatches", file=sys.stderr, flush=True)
    info = device_info(dev)
    return {
        "text_len": int(n),
        "position": fm.layout.position,
        "devices": ranks,
        "backend": r0["backend"],
        "platform": info["platform"],
        "smi": info["smi"],
        "patterns": patterns,
        "pattern_len": plen,
        "locations_checked": checked,
        "locations_above_2_32": hi_hits,
        "mismatches": mismatches,
        "ok": mismatches == 0 and (hi_hits > 0 or n < 2**32),
        "shard_s": r0["shard_s"],
        "shard_rss_before_kb": r0["shard_rss_before_kb"],
        "shard_rss_after_kb": r0["shard_rss_after_kb"],
        "query_s": r0["query_s"],
        "oracle_s": oracle_s,
        "ranks": [{k: r[k] for k in ("rank", "device", "fused_rows", "sa_entries",
                                     "all_reduce_calls", "all_reduce_bytes", "all_reduce_s",
                                     "locate_s", "all_reduce_share")} for r in res],
        "answers": {"starts": starts.tolist(), "counts": r0["counts"],
                    "locations": r0["locations"]},
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--text", required=True)
    ap.add_argument("--blob", required=True)
    ap.add_argument("--patterns", type=int, default=256)
    ap.add_argument("--plen", type=int, default=20)
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--out", default="WIDE_torch.json")
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--device", default=None, help="cpu, or the card by default")
    args = ap.parse_args(argv)
    out = run(args.text, args.blob, args.patterns, args.plen, args.seed, args.ranks,
              args.device)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "answers"}), flush=True)
    if not out["ok"]:
        raise SystemExit("wide scale check FAILED")
    return out


def _child_main(argv) -> None:
    """One rank of a spawned world (``rank --rank R --world N --workdir DIR
    [--device cpu]``): writes ``result<N>_<R>.json`` into the work
    directory."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    if a.device == "cpu":
        import torch

        torch.set_num_threads(1)
    res = _rank(a.workdir, a.world, a.rank, a.device)
    tmp = os.path.join(a.workdir, f"result{a.world}_{a.rank}.json.tmp")
    with open(tmp, "w") as f:
        json.dump(res, f)
    os.replace(tmp, os.path.join(a.workdir, f"result{a.world}_{a.rank}.json"))


if __name__ == "__main__":
    if sys.argv[1:2] == ["rank"]:
        _child_main(sys.argv[2:])
    else:
        main()
