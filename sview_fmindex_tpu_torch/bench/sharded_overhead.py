"""What a one-rank ``ShardedFmIndex`` call costs over the unsharded call, and
where the host spends it: ``python -m sview_fmindex_tpu_torch.bench.sharded_overhead``.

Needs one GPU.  Builds a seeded random DNA index (``--text-size`` bp, default
1e7; sigma 4, Block3<u64>, r=2, k=3), uploads it as the main path does, joins
a one-rank NCCL group and prints, per batch size: the time per call of
``count`` and ``locate`` unsharded and sharded (host clock over ``--reps``
back-to-back calls, then with the device drained), the time of each host-side
piece of a sharded call and of each collective alone, and a ``cProfile`` of
100 sharded and 100 unsharded ``count`` calls at the first batch size.
"""
from __future__ import annotations

import argparse
import cProfile
import os
import pstats
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

import sview_fmindex_tpu_torch as ft
from sview_fmindex_tpu_torch.ops import search as search_ops
from sview_fmindex_tpu_torch.parallel import distributed, query
from sview_fmindex_tpu_torch.parallel.mesh import make_mesh

PATTERN_LEN = 20


def timed(label: str, fn, reps: int) -> None:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    drained = (time.perf_counter() - t0) / reps
    print(f"{label}: host {host * 1e3:.3f} ms, with the device drained {drained * 1e3:.3f} ms",
          flush=True)


def count_overhead(dev, sh, patterns, windows: int = 5, reps: int = 6) -> dict:
    """The sharded ``count`` against the plain one on the same batch:
    ``windows`` windows of ``reps`` calls each, plain and sharded in turns so
    drift lands on both, each window on a host clock synchronised at both
    ends; the median window of each, in seconds per call."""
    def sync() -> None:
        if patterns.is_cuda:
            torch.cuda.synchronize(patterns.device)

    def window(fn) -> float:
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        return (time.perf_counter() - t0) / reps

    plain = lambda: dev.count(patterns, use_stream=True)  # noqa: E731
    sharded = lambda: sh.count(patterns, None)  # noqa: E731
    plain()
    sharded()
    pw, sw = [], []
    for _ in range(windows):
        pw.append(window(plain))
        sw.append(window(sharded))
    p, s = float(np.median(pw)), float(np.median(sw))
    return {"plain_s": p, "sharded_s": s, "overhead_frac": s / p - 1}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--text-size", type=float, default=1e7)
    ap.add_argument("--batches", type=int, nargs="+", default=[100_000, 1_000_000])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this measurement needs a GPU")
    n = int(args.text_size)
    rng = np.random.default_rng(args.seed)
    text = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=n)]
    enc = ft.EncodingTable.from_symbols([b"A", b"C", b"G", b"T"])
    builder = ft.FmIndexBuilder(n, 4, enc, position="u32", block=ft.BLOCK3_U64,
                                suffix_array_config=ft.SuffixArrayConfig.compressed(2),
                                lookup_table_config=ft.LookupTableConfig.kmer_size(3),
                                sa_backend="native")
    fm = ft.FmIndex.load(builder.build(text), position="u32", block=ft.BLOCK3_U64)
    dev = ft.to_device_torch(fm, dense_lut_entries=1 << 28, dense_host_entries=1 << 20,
                             sa_full="device", sa_fill_ratio=4)
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}; text {n} bp, "
          f"dense_k {dev.meta.dense_k}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        distributed.initialize(f"file://{os.path.join(tmp, 'store')}", 1, 0, timeout=120)
        try:
            mesh = make_mesh(axis="dp")
            sh = query.ShardedFmIndex(dev, mesh)
            group = mesh.group("dp")
            for i, B in enumerate(args.batches):
                starts = rng.integers(0, n - PATTERN_LEN, size=B)
                pats = torch.from_numpy(np.ascontiguousarray(
                    text[starts[:, None] + np.arange(PATTERN_LEN)])).cuda()
                cap = sh.locate(pats, None)[0].shape[0]
                print(f"B={B}, capacity {cap}", flush=True)
                timed("unsharded count", lambda: dev.count(pats, use_stream=True), args.reps)
                timed("sharded count", lambda: sh.count(pats, None), args.reps)
                timed("unsharded locate",
                      lambda: dev.locate(pats, capacity=cap, use_stream=True), args.reps)
                timed("sharded locate",
                      lambda: sh.locate(pats, None, capacity_per_shard=cap), args.reps)
                padded, lens, _ = query.pad_batch(pats, None, 1)
                x = torch.arange(B, device="cuda")
                out = torch.empty_like(x)
                for label, fn in (
                        ("pad_batch", lambda: query.pad_batch(pats, None, 1)),
                        ("_facts", lambda: sh._facts(lens, PATTERN_LEN)),
                        ("batch_facts",
                         lambda: search_ops.batch_facts(dev.meta, lens, B, PATTERN_LEN)),
                        ("local_lens", lambda: query.local_lens(mesh, lens, "dp")),
                        ("shard_batch", lambda: distributed.shard_batch(mesh, padded, "dp")),
                        ("gather_rows int64", lambda: distributed.gather_rows(x, group)),
                        ("gather_rows bool", lambda: distributed.gather_rows(x > 5, group)),
                        ("gather_many of 4",
                         lambda: distributed.gather_many((x, x, x > 5, x[:1]), group)),
                        ("all_reduce", lambda: dist.all_reduce(out, group=group))):
                    timed(label, fn, args.reps)
                if i == 0:
                    for label, fn in (("sharded count", lambda: sh.count(pats, None)),
                                      ("unsharded count",
                                       lambda: dev.count(pats, use_stream=True))):
                        prof = cProfile.Profile()
                        prof.enable()
                        for _ in range(100):
                            fn()
                        prof.disable()
                        torch.cuda.synchronize()
                        print(f"cProfile, 100 x {label}:", flush=True)
                        pstats.Stats(prof).sort_stats("cumulative").print_stats(16)
        finally:
            distributed.shutdown()


if __name__ == "__main__":
    main()
