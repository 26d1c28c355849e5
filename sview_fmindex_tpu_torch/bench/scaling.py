"""Scaling-efficiency report: pattern-DP count throughput over 1..N ranks
(port of ``sview_fmindex_tpu.bench.scaling``).

BASELINE.json config 5: the index whole on every rank, a pattern batch
sharded data-parallel (``parallel/query.py``), the counts gathered in rank
order; reports throughput per number of ranks and efficiency against linear
scaling from one rank.

One process per rank replaces the JAX package's device mesh
(``parallel/distributed.py``).  One rank runs in the calling process (NCCL on
a card); N > 1 ranks run as N child processes of this module, which load the
same blob and batch from a work directory.  Where every rank has a GPU of its
own this measures scaling over NVLink (NCCL); where ranks share a device (CPU
ranks, or more ranks than GPUs: gloo, staged through the host) it validates
the sharded program end to end and reports the numbers with ``virtual:
true``, as the JAX package does for its virtual CPU mesh.

Every collective of every group is bounded by ``GROUP_TIMEOUT``, the whole
world by ``JOIN_TIMEOUT``; a child that fails or outlasts the deadline is
killed with its peers and fails the report.

Usage:  python -m sview_fmindex_tpu_torch.bench scaling [-t TEXT_LEN]
        [-n PATTERNS] [--ranks 1,2] [--device cpu]
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

GROUP_TIMEOUT = 120  # seconds, every collective of every group
JOIN_TIMEOUT = 420  # seconds, one world from start to exit
REPS = 3


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _measure(index, mesh, patterns, lens) -> dict:
    """This rank's part of one row: the counts checked, then REPS timed
    sharded counts on a synchronised host clock."""
    import torch.distributed as dist

    from ..parallel.query import ShardedFmIndex

    sharded = ShardedFmIndex(index, mesh=mesh)
    # pin ONE engine across rank counts: the auto heuristic would switch
    # stream -> gather as the per-rank batch shrinks and corrupt the curve
    counts = sharded.count(patterns, lens, use_stream=False)
    if not bool((counts >= 1).all()):
        raise RuntimeError("a pattern cut from the text has count 0")
    dist.barrier()
    t0 = time.time()
    for _ in range(REPS):
        c = sharded.count(patterns, lens, use_stream=False)
        float(c.sum())  # forces the result (and the device) to finish
    secs = time.time() - t0
    return {"qps": REPS * patterns.shape[0] / secs, "hits": int(counts.sum())}


def _fresh_store(workdir: str, world: int, rank: int | None) -> str:
    """The rendezvous file of a ``world``-rank group.  Whoever starts the
    world (``rank`` None: the parent of the children; or the only rank of a
    one-rank world) removes what an earlier run left there."""
    store = os.path.join(workdir, f"store{world}")
    if (rank is None or world == 1) and os.path.exists(store):
        os.remove(store)
    return store


def _rank_run(workdir: str, world: int, rank: int, device: str | None) -> dict:
    """Join a ``world``-rank group, upload the blob of ``workdir`` to this
    rank's device and measure; every rank returns its own numbers."""
    from .. import BLOCK3_U64, FmIndex
    from ..parallel import distributed
    from ..parallel.mesh import make_mesh

    rt = distributed.initialize(f"file://{_fresh_store(workdir, world, rank)}", world, rank,
                                device=device, timeout=GROUP_TIMEOUT)
    try:
        fm = FmIndex.load(np.fromfile(os.path.join(workdir, "index.blob"), np.uint8),
                          position="u32", block=BLOCK3_U64, encoder_kind="table")
        patterns = np.load(os.path.join(workdir, "patterns.npy"))
        lens = np.full(patterns.shape[0], patterns.shape[1], np.int32)
        index = fm.to_device(rt.device)
        out = _measure(index, make_mesh(axis="dp"), patterns, lens)
        out["backend"] = rt.backend
        return out
    finally:
        distributed.shutdown()


def _spawn(workdir: str, world: int, device: str | None, entry: list | None = None) -> list:
    """Run ``world`` ranks as child processes; returns every rank's numbers,
    rank order.  ``entry``: the command a child runs, to which ``--rank R
    --world N --workdir DIR [--device D]`` is added (default: this module's
    rank of the scaling report); it writes ``result<N>_<R>.json`` into the
    work directory."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=pkg_root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    if device == "cpu":
        env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    _fresh_store(workdir, world, None)
    procs = []
    for rank in range(world):
        cmd = [*(entry or [sys.executable, "-m", "sview_fmindex_tpu_torch.bench.scaling"]),
               "--rank", str(rank), "--world", str(world), "--workdir", workdir]
        if device:
            cmd += ["--device", device]
        out = open(os.path.join(workdir, f"rank{world}_{rank}.log"), "wb")
        procs.append((subprocess.Popen(cmd, env=env, stdout=out, stderr=subprocess.STDOUT), out))
    deadline = time.monotonic() + JOIN_TIMEOUT
    failed = None
    try:
        pending = set(range(world))
        while pending and failed is None:
            for rank in sorted(pending):
                rc = procs[rank][0].poll()
                if rc is not None:
                    pending.discard(rank)
                    if rc != 0:
                        failed = f"rank {rank} of {world} exited with code {rc}"
            if pending and failed is None and time.monotonic() > deadline:
                failed = f"ranks {sorted(pending)} of {world} still running after {JOIN_TIMEOUT} s"
            time.sleep(0.05)
    finally:
        for p, out in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            out.close()
    if failed:
        logs = []
        for rank in range(world):
            with open(os.path.join(workdir, f"rank{world}_{rank}.log"), errors="replace") as f:
                logs.append(f"--- rank {rank} ---\n{f.read()[-3000:]}")
        raise RuntimeError(failed + "\n" + "\n".join(logs))
    out = []
    for rank in range(world):
        with open(os.path.join(workdir, f"result{world}_{rank}.json")) as f:
            out.append(json.load(f))
    return out


def run_scaling(text_len: int, pattern_count: int, pattern_len: int = 20,
                seed: int = 42, mesh_sizes=None, device=None, workdir=None,
                per_rank: bool = False) -> dict:
    """The report over ``mesh_sizes`` ranks (default: 1, 2, 4, ... up to the
    GPUs of this host; 1 and 2 on the CPU).  ``device``: None for the card
    (raises where there is none) or ``"cpu"``.  ``workdir``: where the blob,
    the batch and the children's logs go (default: a temporary directory,
    removed afterwards).  ``per_rank``: weak scaling, ``pattern_count``
    patterns for every rank (each row then carries its ``batch``, and its
    efficiency is the one-rank batch time over its own)."""
    import torch

    from .. import (
        BLOCK3_U64,
        EncodingTable,
        FmIndexBuilder,
        LookupTableConfig,
        SuffixArrayConfig,
    )
    from ..models.device_index import resolve_device

    dev = resolve_device(device)  # raises without a card unless the CPU is named
    on_card = dev.type == "cuda"
    n_gpus = torch.cuda.device_count() if on_card else 0
    if mesh_sizes is None:
        mesh_sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_gpus] if on_card else [1, 2]
    if torch.distributed.is_initialized():
        raise RuntimeError("run_scaling starts its own process groups: shut the "
                           "caller's down first")

    rng = np.random.default_rng(seed)
    text = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=text_len)]
    enc = EncodingTable.from_symbols([b"A", b"C", b"G", b"T"])
    builder = FmIndexBuilder(
        text_len, enc.symbol_count(), enc, position="u32", block=BLOCK3_U64,
        suffix_array_config=SuffixArrayConfig.compressed(2),
        lookup_table_config=LookupTableConfig.kmer_size(3))

    def draw(count: int) -> np.ndarray:
        starts = rng.integers(0, text_len - pattern_len, size=count)
        return np.ascontiguousarray(text[starts[:, None] + np.arange(pattern_len)])

    patterns = draw(pattern_count)

    own_dir = workdir is None
    workdir = tempfile.mkdtemp(prefix="sview_scaling_") if own_dir else str(workdir)
    os.makedirs(workdir, exist_ok=True)
    try:
        with open(os.path.join(workdir, "index.blob"), "wb") as f:
            f.write(builder.build(text.tobytes()))
        np.save(os.path.join(workdir, "patterns.npy"), patterns)

        rows = []
        base_qps = None
        virtual = False
        dev_name = None if on_card else "cpu"
        for n in mesh_sizes:
            if per_rank:
                batch = pattern_count * n
                np.save(os.path.join(workdir, "patterns.npy"),
                        patterns if n == 1 else draw(batch))
            res = _rank_run(workdir, 1, 0, dev_name) if n == 1 else _spawn(workdir, n, dev_name)[0]
            # ranks that share a device say nothing of scaling over devices
            virtual = virtual or not on_card or n > n_gpus
            qps = res["qps"]
            if base_qps is None:
                base_qps = qps
            eff = qps / (base_qps * n)
            rows.append({"devices": n, "count_qps": round(qps, 1),
                         "speedup": round(qps / base_qps, 2),
                         "efficiency": round(eff, 3)})
            if per_rank:
                rows[-1]["batch"] = batch
            _log(f"[scaling] {n} rank(s) over {res['backend']}: {qps/1e6:.3f} Mq/s, "
                 f"speedup {qps/base_qps:.2f}x, efficiency {eff:.1%}")
    finally:
        if own_dir:
            shutil.rmtree(workdir, ignore_errors=True)

    return {
        "metric": "pattern_dp_count_scaling",
        "text_len": text_len,
        "pattern_count": pattern_count,
        "platform": "gpu" if on_card else "cpu",
        "virtual": virtual,
        "rows": rows,
    }


def main(args) -> None:
    ranks = getattr(args, "ranks", None)
    report = run_scaling(args.text_length, args.pattern_count,
                         mesh_sizes=[int(r) for r in ranks.split(",")] if ranks else None,
                         device=getattr(args, "device", None))
    print(json.dumps(report))


def _child_main(argv) -> None:
    """One rank of a spawned world: ``--rank R --world N --workdir DIR
    [--device cpu]``; writes ``result<N>_<R>.json`` into the work directory."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    if a.device == "cpu":
        import torch

        torch.set_num_threads(1)
    res = _rank_run(a.workdir, a.world, a.rank, a.device)
    tmp = os.path.join(a.workdir, f"result{a.world}_{a.rank}.json.tmp")
    with open(tmp, "w") as f:
        json.dump(res, f)
    os.replace(tmp, os.path.join(a.workdir, f"result{a.world}_{a.rank}.json"))


if __name__ == "__main__":
    _child_main(sys.argv[1:])
