#!/usr/bin/env python3
"""Scaling evidence for the port's parallel layer: the PyTorch port's
counterpart of ``tools/scaling_report.py``, in its three parts.

1. **Weak scaling**: a constant per-rank batch (``--per-rank`` patterns of
   20 bp, default 25,000) at 1, 2 and 4 ranks, through ``bench/scaling.py``'s
   process harness (``ShardedFmIndex`` count, gather engine pinned).  One rank
   runs in this process (NCCL on the card); more ranks are gloo processes
   that share ``cuda:0`` (or the CPU), so the curve measures host contention,
   not a link: the report says ``virtual: true`` beside the host's cores.
2. **Sharded overhead at one rank**: ``bench/sharded_overhead.count_overhead``,
   the sharded count against the plain one on the same batch.
3. **Communication model**: the bytes a batch of ``--model-batch`` patterns
   moves between ranks, taken from the collectives as the code makes them
   (pattern-parallel: ``distributed.gather_rows`` of the counts,
   ``gather_many`` of the located slots; range shards: one
   ``range_shard._owned_gather`` ``all_reduce`` of [2B, fused width] int32
   per LF step) and held against ``range_shard.STATS`` of a real call; the
   time per batch of the unsharded locate, measured in this run on this
   device; link rates of the H100 SXM data sheet (NVLink 4, PCIe Gen5 x16);
   and a measured floor, the same payloads through a two-process gloo
   collective timed in this run.

Usage:  python3 tools/torch_scaling_report.py [--text-size 2e6] [--per-rank 25000]
        [--ranks 1,2,4] [--model-batch 1000000] [--device cpu] [--out PATH]

Prints one JSON line (the weak-scaling rows included) and writes it to
``--out``.  Runs on the card unless ``--device cpu`` is given; raises where
there is no card and the CPU was not named.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

PATTERN_LEN = 20
SEED = 1
# H100 SXM data sheet, both directions together; a transfer uses one
NVLINK_BYTES_PER_S = 900e9  # NVLink 4
PCIE_BYTES_PER_S = 128e9  # PCIe Gen5 x16
COLLECTIVE_REPS = 10
GROUP_TIMEOUT = 120  # seconds, every collective


def comm_bytes(B: int, D: int, capacity_per_shard: int, steps: int, fused_width: int) -> dict:
    """Bytes of the collectives of one batch of ``B`` patterns over ``D``
    ranks, as the code makes them.  Pattern-parallel (``parallel/query.py``):
    a count gathers the int64 counts of the padded batch (``gather_rows``:
    every rank ends with all of them); a locate gathers them once to size
    the capacity, then ``gather_many`` moves locations, pattern ids and
    valid flags (``capacity_per_shard`` each) and the dropped count as one
    int64 row per rank.  Range shards (``parallel/range_shard.py``): every LF
    step reduces the fused rows of the 2B range ends, int32 [2B, fused
    width], as ``range_shard.STATS`` counts them (the input of one
    ``all_reduce``)."""
    b_pad = -(-B // D) * D
    count = b_pad * 8
    step = 2 * b_pad * fused_width * 4
    return {"dp_count_gather_bytes": count,
            "dp_locate_gather_bytes": count + D * (3 * capacity_per_shard + 1) * 8,
            "rs_all_reduce_bytes_per_step": step, "rs_count_steps": steps,
            "rs_count_all_reduce_bytes": steps * step}


def _seconds_per_call(fn, B: int, device) -> float:
    """Median seconds per call of ``fn`` over 5 windows of 3 calls on a host
    clock synchronised at both ends (``bench.timing.window_rates``)."""
    from sview_fmindex_tpu_torch.bench.timing import window_rates

    return B / float(np.median(window_rates(fn, B, 3, 5, device=device)["host"]))


def one_rank_parts(text_size: int, B: int, device, workdir: str) -> dict:
    """Parts 2 and 3 in one rank of this process: the unsharded time per
    batch, the sharded overhead, and the bytes of each collective at one
    rank (the model's input), held against ``range_shard.STATS``."""
    import torch

    import sview_fmindex_tpu_torch as ft
    from sview_fmindex_tpu_torch.bench.sharded_overhead import count_overhead
    from sview_fmindex_tpu_torch.ops import search as search_ops
    from sview_fmindex_tpu_torch.parallel import distributed, range_shard
    from sview_fmindex_tpu_torch.parallel.mesh import make_mesh
    from sview_fmindex_tpu_torch.parallel.query import ShardedFmIndex
    from sview_fmindex_tpu_torch.parallel.range_shard import RangeShardedFmIndex

    rng = np.random.default_rng(SEED)
    text = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=text_size)]
    enc = ft.EncodingTable.from_symbols([b"A", b"C", b"G", b"T"])
    builder = ft.FmIndexBuilder(text_size, 4, enc, position="u32", block=ft.BLOCK3_U64,
                                suffix_array_config=ft.SuffixArrayConfig.compressed(2),
                                lookup_table_config=ft.LookupTableConfig.kmer_size(3))
    fm = ft.FmIndex.load(np.frombuffer(builder.build(text), np.uint8), position="u32",
                         block=ft.BLOCK3_U64)
    starts = rng.integers(0, text_size - PATTERN_LEN, size=B)
    pats_np = np.ascontiguousarray(text[starts[:, None] + np.arange(PATTERN_LEN)])
    lens = np.full(B, PATTERN_LEN, np.int32)
    rt = distributed.initialize(f"file://{os.path.join(workdir, 'store_one')}", 1, 0,
                                device=None if device.type == "cuda" else "cpu",
                                timeout=GROUP_TIMEOUT)
    try:
        dev = ft.to_device_torch(fm, rt.device)
        pats = torch.from_numpy(pats_np).to(rt.device)
        count_s = _seconds_per_call(lambda: dev.count(pats, use_stream=True), B, rt.device)
        locate_s = _seconds_per_call(lambda: dev.locate(pats, use_stream=True), B, rt.device)
        sh = ShardedFmIndex(dev, make_mesh(axis="dp"))
        overhead = count_overhead(dev, sh, pats)
        locs = sh.locate(pats, None)[0]
        rs = RangeShardedFmIndex(fm, make_mesh(axis="rs"))
        for k in range_shard.STATS:
            range_shard.STATS[k] = 0
        rs.count(pats, lens)
        measured = dict(range_shard.STATS)
        steps = search_ops.batch_facts(rs.meta, lens, B, PATTERN_LEN)[0]
        model = comm_bytes(B, 1, locs.shape[0], steps, rs.fused.shape[1])
        if measured["all_reduce_bytes"] != model["rs_count_all_reduce_bytes"]:
            raise RuntimeError(f"the model's range-shard bytes {model} differ from the "
                               f"code's {measured}")
        return {"count_s": count_s, "locate_s": locate_s, "overhead": overhead,
                "capacity": int(locs.shape[0]), "steps": steps,
                "fused_width": int(rs.fused.shape[1]), "rs_stats": measured,
                "dense_k": {"device": dev.meta.dense_k, "range_shard": rs.meta.dense_k}}
    finally:
        distributed.shutdown()


def measured_collective(workdir: str, sizes: dict) -> dict:
    """The model's payloads through a real process boundary: two gloo
    processes on the host, each payload ``COLLECTIVE_REPS`` times; seconds
    per call, the slower rank's."""
    from sview_fmindex_tpu_torch.bench.scaling import _spawn

    with open(os.path.join(workdir, "collective.json"), "w") as f:
        json.dump(sizes, f)
    res = _spawn(workdir, 2, "cpu",
                 entry=[sys.executable, os.path.abspath(__file__), "collective"])
    return {k: max(r[k] for r in res) for k in res[0]}


def _collective_rank(workdir: str, world: int, rank: int) -> dict:
    """One rank of :func:`measured_collective`."""
    import torch
    import torch.distributed as dist

    from sview_fmindex_tpu_torch.bench.scaling import _fresh_store
    from sview_fmindex_tpu_torch.parallel import distributed

    with open(os.path.join(workdir, "collective.json")) as f:
        sizes = json.load(f)
    distributed.initialize(f"file://{_fresh_store(workdir, world, rank)}", world, rank,
                           device="cpu", timeout=GROUP_TIMEOUT)
    try:
        out = {}
        group = dist.group.WORLD
        gather = torch.ones(sizes["gather_int64_per_rank"], dtype=torch.int64)
        reduce = torch.ones(sizes["all_reduce_int32"], dtype=torch.int32)
        for name, fn in (("gather_s", lambda: distributed.gather_rows(gather, group)),
                         ("all_reduce_s", lambda: distributed.all_reduce_sum(reduce, group))):
            fn()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(COLLECTIVE_REPS):
                fn()
            out[name] = (time.perf_counter() - t0) / COLLECTIVE_REPS
        return out
    finally:
        distributed.shutdown()


def comm_model(one: dict, B: int, D: int, floor: dict) -> dict:
    """The model at ``D`` ranks: bytes from :func:`comm_bytes` with the
    one-rank capacity split over the ranks, over each link, against the
    measured time per batch (no overlap of compute and transfer)."""
    cap = -(-one["capacity"] // D)
    b = comm_bytes(B, D, cap, one["steps"], one["fused_width"])
    per_batch = one["locate_s"]
    # what crosses a rank's link: all but its own share of a gather; a ring
    # all_reduce sends 2 (D - 1) / D of its input
    cross = {"dp_locate": b["dp_locate_gather_bytes"] * (D - 1) / D,
             "rs_count": b["rs_count_all_reduce_bytes"] * 2 * (D - 1) / D}
    out = {"ranks": D, "batch": B, "capacity_per_shard": cap, **b,
           "measured_compute_s_per_batch": per_batch,
           "links_bytes_per_s": {"nvlink": NVLINK_BYTES_PER_S, "pcie_gen5": PCIE_BYTES_PER_S},
           "links_source": "H100 SXM data sheet (NVLink 4 900 GB/s, PCIe Gen5 x16 128 GB/s, "
                           "both directions together; half each way)"}
    for link, rate in (("nvlink", NVLINK_BYTES_PER_S), ("pcie_gen5", PCIE_BYTES_PER_S)):
        for what, nbytes in cross.items():
            t = nbytes / (rate / 2)
            out[f"{what}_s_{link}"] = t
            out[f"{what}_efficiency_{link}"] = per_batch / (per_batch + t)
    out["dp_locate_efficiency_floor_gloo"] = per_batch / (per_batch + floor["gather_s"])
    out["rs_step_efficiency_floor_gloo"] = (
        per_batch / (per_batch + one["steps"] * floor["all_reduce_s"]))
    return out


def report(text_size: int, per_rank: int, ranks: list, model_batch: int, device=None) -> dict:
    """The three parts on ``device`` (the card, or ``"cpu"``), as one dict."""
    import torch

    from sview_fmindex_tpu_torch.bench.scaling import run_scaling
    from sview_fmindex_tpu_torch.bench.timing import device_info
    from sview_fmindex_tpu_torch.models.device_index import resolve_device

    dev = resolve_device(device)  # raises without a card unless the CPU is named
    info = device_info(dev)
    weak = run_scaling(text_size, per_rank, PATTERN_LEN, seed=SEED, mesh_sizes=ranks,
                       device=None if dev.type == "cuda" else "cpu", per_rank=True)
    with tempfile.TemporaryDirectory(prefix="sview_scaling_report_") as work:
        one = one_rank_parts(text_size, model_batch, dev, work)
        D = 2
        cap = -(-one["capacity"] // D)
        sizes = {"gather_int64_per_rank": 3 * cap + 1,
                 "all_reduce_int32": 2 * (-(-model_batch // D) * D) * one["fused_width"]}
        floor = measured_collective(work, sizes)
    cores = os.cpu_count()
    return {
        "platform": info["platform"], "device": info["name"], "smi": info["smi"],
        "device_count": torch.cuda.device_count() if dev.type == "cuda" else 0,
        "host_cores": cores,
        "virtual": weak["virtual"],
        "virtual_note": (f"ranks past the first share one device and this host's {cores} "
                         "cores: the weak-scaling curve measures host contention, not a link"),
        "text_size": text_size, "per_rank_batch": per_rank,
        "weak_scaling": weak["rows"],
        "shard_overhead_rank1": one["overhead"],
        "comm_model": comm_model(one, model_batch, D, floor),
        "measured_collective": {
            "what": "2 gloo processes on the host: gather_rows of the dp locate payload, "
                    "all_reduce_sum of one LF step's rows; seconds per call, slower rank",
            **sizes, **floor},
        "one_rank": {k: one[k] for k in ("count_s", "locate_s", "capacity", "steps",
                                         "fused_width", "rs_stats", "dense_k")},
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--text-size", type=float, default=2e6)
    ap.add_argument("--per-rank", type=int, default=25_000)
    ap.add_argument("--ranks", default="1,2,4")
    ap.add_argument("--model-batch", type=int, default=1_000_000)
    ap.add_argument("--device", default=None, help="cpu, or the card by default")
    ap.add_argument("--out", default="SCALING_torch.json")
    args = ap.parse_args(argv)
    out = report(int(args.text_size), args.per_rank, [int(r) for r in args.ranks.split(",")],
                 args.model_batch, args.device)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


def _child_main(argv) -> None:
    """One rank of the measured collective (``collective --rank R --world N
    --workdir DIR --device cpu``): writes ``result<N>_<R>.json``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    import torch

    torch.set_num_threads(1)
    res = _collective_rank(a.workdir, a.world, a.rank)
    tmp = os.path.join(a.workdir, f"result{a.world}_{a.rank}.json.tmp")
    with open(tmp, "w") as f:
        json.dump(res, f)
    os.replace(tmp, os.path.join(a.workdir, f"result{a.world}_{a.rank}.json"))


if __name__ == "__main__":
    if sys.argv[1:2] == ["collective"]:
        _child_main(sys.argv[2:])
    else:
        main()
