"""Run a job on N ranks of the PyTorch port's ``parallel`` layer: gloo
processes on the CPU, one thread each.

The test side (:func:`run_ranks`) writes the job to a pickle, starts one
``python torch_dist_harness.py`` process per rank with a ``file://`` store
under the caller's directory (no TCP port: test files run side by side),
waits with a deadline, kills every child on failure, and returns each
rank's results.  The worker side (:func:`main`) imports the port only.

A job::

    {"blob": path, "load": {FmIndex.load keywords},
     "fail_rank": optional rank that raises before its first case,
     "cases": [{"name": str, "kind": "sharded" | "range",
                "mesh": {"axis": "dp"} | {"shape": (2, 2), "axes": ("rs", "dp")},
                "init": {constructor keywords},
                "calls": [(method, args tuple, kwargs dict), ...]}]}

A call with a fourth element, ``(method, args, kwargs, "raises")``, is
expected to raise ``ValueError`` on every rank; its result is ``("raised",
message)``.

Each rank returns ``{case name: {"calls": [numpy results...], "info": {...},
"stats": [range_shard.STATS after each call that returned...]}}``.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT = 60  # seconds, every collective of every group
JOIN_TIMEOUT = 150  # seconds, the whole world


def run_ranks(world: int, job: dict, workdir) -> list:
    """Run ``job`` on ``world`` ranks; returns the per-rank results, rank
    order.  Raises (after killing every child) if a rank fails or the
    deadline passes."""
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    job_path = os.path.join(workdir, "job.pkl")
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = []
    for rank in range(world):
        log = open(os.path.join(workdir, f"rank{rank}.log"), "wb")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), workdir, str(world), str(rank)],
            env=env, stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + JOIN_TIMEOUT
    failed = None
    try:
        pending = set(range(world))
        while pending and failed is None:
            for rank in sorted(pending):
                rc = procs[rank][0].poll()
                if rc is None:
                    continue
                pending.discard(rank)
                if rc != 0:
                    failed = f"rank {rank} of {world} exited with code {rc}"
                    break
            if pending and failed is None:
                if time.monotonic() > deadline:
                    failed = f"ranks {sorted(pending)} of {world} still running after {JOIN_TIMEOUT} s"
                else:
                    time.sleep(0.05)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    if failed:
        logs = []
        for rank in range(world):
            with open(os.path.join(workdir, f"rank{rank}.log"), errors="replace") as f:
                logs.append(f"--- rank {rank} ---\n{f.read()[-3000:]}")
        raise RuntimeError(failed + "\n" + "\n".join(logs))
    out = []
    for rank in range(world):
        with open(os.path.join(workdir, f"out{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _to_numpy(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, (tuple, list)):
        return tuple(_to_numpy(v) for v in x)
    return x


def main(workdir: str, world: int, rank: int) -> None:
    import numpy as np
    import torch

    torch.set_num_threads(1)
    import sview_fmindex_tpu_torch as ft
    from sview_fmindex_tpu_torch.ops import stream_join
    from sview_fmindex_tpu_torch.parallel import distributed
    from sview_fmindex_tpu_torch.parallel.mesh import make_mesh
    from sview_fmindex_tpu_torch.parallel.query import ShardedFmIndex
    from sview_fmindex_tpu_torch.parallel import range_shard
    from sview_fmindex_tpu_torch.parallel.range_shard import RangeShardedFmIndex

    with open(os.path.join(workdir, "job.pkl"), "rb") as f:
        job = pickle.load(f)
    distributed.initialize(f"file://{workdir}/store", world, rank, device="cpu",
                           timeout=GROUP_TIMEOUT)
    load = dict(job["load"])
    load["block"] = ft.BlockKind(*load["block"])
    fm = ft.FmIndex.load(np.fromfile(job["blob"], np.uint8), **load)
    meshes = {}
    results = {}
    if job.get("fail_rank") == rank:
        raise RuntimeError(f"rank {rank} fails on request")
    for case in job["cases"]:
        spec = case["mesh"]
        key = repr(sorted(spec.items()))
        if key not in meshes:
            meshes[key] = make_mesh(**spec)
        mesh = meshes[key]
        init = dict(case.get("init", {}))
        info = {}
        if case["kind"] == "sharded":
            upload = init.pop("upload", {})
            obj = ShardedFmIndex(ft.to_device_torch(fm, "cpu", **upload), mesh, **init)
            info.update(wide=obj.index.meta.wide_pos, n_devices=obj.n_devices)
        else:
            obj = RangeShardedFmIndex(fm, mesh, **init)
            info.update(fused_rows=obj.fused.shape[0], sa_len=obj.sa.shape[0],
                        n_blocks=fm.rank_checkpoints.shape[0],
                        n_sa=fm.suffix_array.shape[0], text_len=fm.text_len,
                        has_sa_full=obj.meta.has_sa_full, dp_size=obj.dp_size,
                        sa_dtype=str(obj.sa.dtype), fused_width=obj.fused.shape[1],
                        kmer_size=obj.meta.kmer_size, dense_k=obj.meta.dense_k)
        calls, stats = [], []
        for method, args, kwargs, *expect in case["calls"]:
            for k in range_shard.STATS:
                range_shard.STATS[k] = 0
            try:
                calls.append(_to_numpy(getattr(obj, method)(*args, **kwargs)))
                stats.append(dict(range_shard.STATS))
            except ValueError as exc:
                if expect != ["raises"]:
                    raise
                calls.append(("raised", str(exc)))
            else:
                assert not expect, f"{method} was expected to raise"
        results[case["name"]] = {"calls": calls, "info": info, "stats": stats}
    assert "jax" not in sys.modules and "sview_fmindex_tpu" not in sys.modules
    assert not any(stream_join.LAUNCHES.values())  # the CPU runs the plain version
    tmp = os.path.join(workdir, f"out{rank}.pkl.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(results, f)
    os.replace(tmp, os.path.join(workdir, f"out{rank}.pkl"))
    distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
