"""Benchmark sweep of the PyTorch/CUDA port: CSV parity with the
reference's ``run_benchmark.sh``, the counterpart of ``run_benchmark.py`` on
``sview_fmindex_tpu_torch``.

Sweeps {10, 1_000, 100_000} patterns x cold {1%, 10%, 100%} x algorithms
and writes the reference CSV schema

    pattern_count,cold_ratio,algorithm,total_ns,load_percent,max_rss_kb

Algorithms (reference: lt-fm-index / sview-memory / sview-mmap):
- ``memory``  blob fully read into RAM (``fs::read`` analog), the batched
  ``DeviceFmIndex`` on the CPU (gather engine, no stream or pair table)
- ``mmap``    np.memmap blob (page-fault on demand), the scalar host
  ``FmIndex`` straight over the blob views (the tiny-RSS disk-serving path)
- ``device``  blob uploaded to the GPU with the headline bench's upload
  (``bench_torch.UPLOAD_KW``), the pair-stream engine

Each cell runs in a FRESH subprocess (like each reference run), so
``max_rss_kb`` (the cell's own ``VmHWM``; where the kernel prints none,
``ru_maxrss``, marked as such in the cell's JSON and the log) and the
load/query split are honest per cell.  ``total_ns`` is end to end inside the cell: imports, blob load
(+ CUDA context, kernel library load, upload and warm-up for ``device``),
query and result write.  ``load_percent`` is the share of ``total_ns`` before
the first timed query.  A ``device`` cell reports its load as phases:
``cuda_init_ns``, ``kernel_load_ns``, ``blob_read_ns``, ``view_load_ns``,
``upload_ns``, ``warm_ns``.  The join kernel is built by ``nvcc`` at first
use; the sweep triggers that build once, before the first ``device`` cell,
and says so, so that no cell times the compiler.  The page cache is dropped
before each mmap cell when permitted; the sweep records whether it was.

A cell that fails (a non-zero exit, or a last line that is not the cell's
JSON) is reported, the other cells still run and the CSV is written, and then
the sweep exits non-zero.

Text and blob are the headline bench's, cached under ``BENCH_CACHE_DIR``
(default ``./bench_cache``), where the result files and, by default, the CSV
go too.

Usage:
  python run_benchmark_torch.py --text-size 1e9 --out RUNBENCH_torch.csv
  python run_benchmark_torch.py --algorithms device --patterns 100000 --colds 1.0
  python run_benchmark_torch.py --algorithms memory,mmap --device cpu   # no GPU
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import bench_torch  # noqa: E402  (numpy only at import; torch loads inside its functions)

SEED = bench_torch.SEED
PATTERN_LEN = bench_torch.PATTERN_LEN
CSV_HEADER = "pattern_count,cold_ratio,algorithm,total_ns,load_percent,max_rss_kb\n"
DEVICE_ALGOS = ("device", "device-warm")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# the headline bench's cache directory and file names
cache_dir = bench_torch.cache_dir
text_path = bench_torch.text_path
blob_path = bench_torch.blob_path


def ensure_inputs(text_size: int) -> None:
    bench_torch.get_blob(bench_torch.get_text(text_size))


def gen_patterns(text_size: int, count: int, cold_ratio: float, seed: int):
    """Reference semantics (bench/src/generate.rs:56-144): cold = fresh
    substrings of the text, warm = cyclic repeats of the cold set."""
    text = np.memmap(text_path(text_size), dtype=np.uint8, mode="r")
    rng = np.random.default_rng(seed)
    # at least one cold pattern: warm patterns are repeats OF the cold set
    # (generate.rs:96-128), so cold_ratio=0 still needs a seed pattern
    cold_count = max(min(int(np.ceil(cold_ratio * count)), count), 1)
    starts = rng.integers(0, text_size - PATTERN_LEN + 1, size=cold_count)
    cold = text[np.asarray(starts)[:, None] + np.arange(PATTERN_LEN)]
    if count > cold_count:
        reps = -(-count // cold_count)
        pats = np.tile(cold, (reps, 1))[:count]
    else:
        pats = cold
    return pats


def drop_caches() -> bool:
    try:
        with open("/proc/sys/vm/drop_caches", "w") as f:
            f.write("3\n")
        return True
    except OSError:
        return False


def peak_rss_kb() -> tuple:
    """(this process's peak resident set in kB, where the number is from).
    ``VmHWM`` of ``/proc/self/status`` starts from zero at exec, so it is the
    cell's own.  ``ru_maxrss`` is not: a fork hands the parent's resident set
    down across exec, so every cell reports at least what the sweep held (a
    blob build, say).  Some kernels (a sandboxed one) print no ``VmHWM``;
    there ``ru_maxrss`` is all there is, and the source says so: the cell's
    JSON carries it and the sweep marks the row's log line."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]), "VmHWM"
    except OSError:
        pass
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss, "ru_maxrss"


def write_by_pattern(path: str, locs, pids, valid) -> None:
    """Every located position on a line of its own, grouped by pattern in
    batch order (a stable sort keeps a pattern's slot order)."""
    order = np.argsort(pids[valid], kind="stable")
    with open(path, "w") as f:
        f.write("\n".join(map(str, locs[valid][order])))


# ---------------------------------------------------------------------------
# cell runner (subprocess entry)
# ---------------------------------------------------------------------------

def run_cell(args) -> None:
    t_all = time.perf_counter_ns()
    algo = args.algorithm
    if algo not in ("memory", "mmap") + DEVICE_ALGOS:
        raise ValueError(f"unknown algorithm {algo!r}")
    text_size = int(float(args.text_size))
    pats = gen_patterns(text_size, int(args.patterns), float(args.cold), SEED + 1)
    out_path = os.path.join(cache_dir(), f"results_{algo}.txt")

    phases = {}
    t_ph = time.perf_counter_ns()
    import sview_fmindex_tpu_torch as ft

    phases["import_ns"] = time.perf_counter_ns() - t_ph

    load_start = time.perf_counter_ns()
    on_device = algo in DEVICE_ALGOS
    if on_device:
        import torch

        from sview_fmindex_tpu_torch.models.device_index import resolve_device

        device = resolve_device(args.device)  # raises without a card unless the CPU is named
        if device.type == "cuda":
            torch.cuda.init()
            torch.zeros(1, device=device)
            torch.cuda.synchronize(device)
            phases["cuda_init_ns"] = time.perf_counter_ns() - load_start
            t_ph = time.perf_counter_ns()
            from sview_fmindex_tpu_torch import kernels

            kernels.join_lib()  # built before the sweep's first device cell
            phases["kernel_load_ns"] = time.perf_counter_ns() - t_ph
    t_ph = time.perf_counter_ns()
    if algo == "mmap":
        blob = np.memmap(blob_path(text_size), dtype=np.uint8, mode="r")
    else:
        blob = np.fromfile(blob_path(text_size), dtype=np.uint8)
    phases["blob_read_ns"] = time.perf_counter_ns() - t_ph
    t_ph = time.perf_counter_ns()
    fm = ft.FmIndex.load(blob, position="u32", block=ft.BLOCK3_U64, encoder_kind="table")
    phases["view_load_ns"] = time.perf_counter_ns() - t_ph
    serve = 0
    if algo != "mmap":
        from sview_fmindex_tpu_torch.bench.timing import force
        from sview_fmindex_tpu_torch.ops.locate import expand_capacity

        t_ph = time.perf_counter_ns()
        if on_device:
            dev = bench_torch.upload(fm, device)
        else:
            # in-memory path on the CPU: gather engine only, so no stream or
            # pair table is built, and the dense seed table stays at the
            # host level (cached like a blob section)
            os.makedirs(cache_dir(), exist_ok=True)
            dev = fm.to_device("cpu", stream=False, pair=False, dense_lut_entries=1 << 20,
                               dense_lut_cache=os.path.join(
                                   cache_dir(), "dense_cpu_memory_torch.npz"))
        force(dev.fused)
        phases["upload_ns"] = time.perf_counter_ns() - t_ph
        # warm the real batch shapes, so load_ns covers what a first query
        # pays beyond the upload
        use_stream = on_device
        t_ph = time.perf_counter_ns()
        cap = expand_capacity(dev.count(pats, use_stream=use_stream).cpu().numpy())
        force(dev.locate_with_counts(pats, capacity=cap, use_stream=use_stream))
        phases["warm_ns"] = time.perf_counter_ns() - t_ph
        load_ns = time.perf_counter_ns() - load_start

        def serve_once():
            locs, pids, valid, _, dropped = dev.locate_with_counts(
                pats, capacity=cap, use_stream=use_stream)
            if int(dropped[0]) != 0:
                raise RuntimeError("capacity overflow dropped hits")
            write_by_pattern(out_path, *(t.cpu().numpy() for t in (locs, pids, valid)))

        q_start = time.perf_counter_ns()
        dev.count(pats, use_stream=use_stream).cpu()
        serve_once()
        query_ns = time.perf_counter_ns() - q_start
        if algo == "device-warm":
            # resident-server mode: the index stays uploaded and serves
            # repeated batches; the amortized per-batch latency (query +
            # result write) is the serving number the one-shot cells cannot
            # show (their total is mostly load)
            serve = int(args.serve_batches or 8)
            q_start = time.perf_counter_ns()
            for _ in range(serve):
                serve_once()
            query_ns = (time.perf_counter_ns() - q_start) // serve
            load_ns = 0  # amortized away in a resident server
    else:
        load_ns = time.perf_counter_ns() - load_start
        q_start = time.perf_counter_ns()
        with open(out_path, "w") as f:
            for p in pats:
                f.write(",".join(map(str, fm.locate(p.tobytes()))) + "\n")
        query_ns = time.perf_counter_ns() - q_start

    # a device-warm total is the amortized serving latency, not a cold start
    total_ns = query_ns if serve else time.perf_counter_ns() - t_all
    rss_kb, rss_source = peak_rss_kb()
    cell = {"total_ns": total_ns, "load_ns": load_ns, "query_ns": query_ns,
            "max_rss_kb": rss_kb, "max_rss_source": rss_source, "phases": phases}
    if on_device:
        from sview_fmindex_tpu_torch.ops import stream_join

        # join-kernel launches of the whole cell (upload, warm-up, query), per mode
        cell["launches"] = dict(stream_join.LAUNCHES)
    if serve:
        # marked, so that nothing downstream compares it with the one-shot rows
        cell["amortized"] = True
        cell["serve_batches"] = serve
    print(json.dumps(cell))


# ---------------------------------------------------------------------------
# resident-server grid: ONE upload serves every cell (a resident server
# amortizes load by definition, so the grid in one process is the honest
# device-warm measurement)
# ---------------------------------------------------------------------------

def run_serve_grid(args) -> list:
    import sview_fmindex_tpu_torch as ft
    from sview_fmindex_tpu_torch.bench.timing import force
    from sview_fmindex_tpu_torch.models.device_index import resolve_device
    from sview_fmindex_tpu_torch.ops.locate import expand_capacity

    device = resolve_device(args.device)
    text_size = int(float(args.text_size))
    ensure_inputs(text_size)
    blob = np.memmap(blob_path(text_size), dtype=np.uint8, mode="r")
    fm = ft.FmIndex.load(blob, position="u32", block=ft.BLOCK3_U64, encoder_kind="table")
    t0 = time.time()
    dev = bench_torch.upload(fm, device)
    force(dev.fused)
    log(f"[serve-grid] upload {time.time()-t0:.1f}s; serving cells")

    counts_list = [int(float(p)) for p in (args.patterns or "10,1000,100000").split(",")]
    colds = [float(c) for c in (args.colds or "0.01,0.1,1.0").split(",")]
    S = int(args.serve_batches or 8)
    rows = []
    out_path = os.path.join(cache_dir(), "results_device-warm.txt")
    for count in counts_list:
        for cold in colds:
            pats = gen_patterns(text_size, count, cold, SEED + 1)
            cap = expand_capacity(dev.count(pats).cpu().numpy())

            def serve_once():
                locs, pids, valid, _, dropped = dev.locate_with_counts(pats, capacity=cap)
                if int(dropped[0]) != 0:
                    raise RuntimeError("capacity overflow dropped hits")
                write_by_pattern(out_path, *(t.cpu().numpy() for t in (locs, pids, valid)))

            serve_once()  # warm this exact shape, then S timed batches
            t0 = time.perf_counter_ns()
            for _ in range(S):
                serve_once()
            per_batch_ns = (time.perf_counter_ns() - t0) // S
            rows.append((count, cold, "device-warm", per_batch_ns, 0, 0))
            log(f"[serve-grid] {count:>7} cold={cold:<5} "
                f"{per_batch_ns/1e6:8.1f} ms/batch amortized "
                f"({count/(per_batch_ns/1e9)/1e6:.3f} Mq/s)")
    return rows


# ---------------------------------------------------------------------------
# the sweep itself
# ---------------------------------------------------------------------------

def write_csv(target: str, rows: list, merge: bool, keep) -> int:
    """Write ``rows`` to ``target``; with ``merge`` the lines of an existing
    file that ``keep(count, cold, algo)`` accepts stay.  Returns how many
    stayed."""
    kept = []
    if merge and os.path.exists(target):
        with open(target) as f:
            f.readline()
            for line in f:
                c, cr, algo = line.split(",")[:3]
                if keep(int(c), float(cr), algo):
                    kept.append(line.rstrip("\n"))
    os.makedirs(os.path.dirname(os.path.abspath(target)), exist_ok=True)
    with open(target, "w") as f:
        f.write(CSV_HEADER)
        for line in kept:
            f.write(line + "\n")
        for r in rows:
            f.write(",".join(map(str, r)) + "\n")
    return len(kept)


def prebuild_kernel() -> None:
    """Build the join kernel in a process of its own, so that no cell's
    ``kernel_load_ns`` holds the compiler."""
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-c",
         "from sview_fmindex_tpu_torch import kernels; kernels.join_lib()"],
        capture_output=True, text=True, cwd=REPO)
    if proc.returncode != 0:
        raise RuntimeError(f"the join kernel did not build:\n{proc.stderr[-2000:]}")
    log(f"[sweep] join kernel built or found in {time.time()-t0:.1f}s, before the first "
        f"device cell (no cell times the compiler)")


CELL_KEYS = {"total_ns", "load_ns", "query_ns", "max_rss_kb", "max_rss_source", "phases"}


def parse_cell(proc):
    """The JSON object a cell printed as its last line, or None where the
    cell failed: a non-zero exit, no output, or a line that is not it."""
    if proc.returncode != 0:
        return None
    try:
        cell = json.loads(proc.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        return None
    return cell if isinstance(cell, dict) and CELL_KEYS <= set(cell) else None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--text-size", default="1e9")
    ap.add_argument("--patterns", default=None,
                    help="comma list; default 10,1000,100000")
    ap.add_argument("--colds", default=None, help="comma list; default 0.01,0.1,1.0")
    ap.add_argument("--algorithms", default="memory,mmap,device")
    ap.add_argument("--out", default=None,
                    help="the CSV (default: RUNBENCH_torch.csv in the cache directory)")
    ap.add_argument("--device", default=None,
                    help="torch device of the device algorithms (default: the "
                         "current CUDA device; 'cpu' names the CPU)")
    ap.add_argument("--no-drop-caches", action="store_true")
    ap.add_argument("--cell", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--cold", default="1.0", help=argparse.SUPPRESS)
    ap.add_argument("--algorithm", default="memory", help=argparse.SUPPRESS)
    ap.add_argument("--serve-batches", type=int, default=8,
                    help="timed batches per device-warm cell")
    ap.add_argument("--serve-grid", action="store_true",
                    help="resident-server mode: one upload serves the full "
                         "patterns x colds grid; rows are amortized "
                         "per-batch latencies (device-warm)")
    ap.add_argument("--merge-into", default=None,
                    help="merge produced rows into this existing CSV "
                         "(serve-grid: replacing device-warm rows; sweep: "
                         "replacing matching (count,cold,algo) rows) instead "
                         "of overwriting --out")
    ap.add_argument("--phases-out", default=None,
                    help="also write the per-cell JSON (incl. phase "
                         "breakdowns) to this path")
    args = ap.parse_args(argv)

    if args.cell:
        run_cell(args)
        return

    target = args.merge_into or args.out or os.path.join(cache_dir(), "RUNBENCH_torch.csv")
    if args.serve_grid:
        rows = run_serve_grid(args)
        write_csv(target, rows, bool(args.merge_into), lambda c, cr, a: a != "device-warm")
        log(f"[serve-grid] wrote {len(rows)} device-warm rows to {target}")
        return

    text_size = int(float(args.text_size))
    patterns = [int(float(p)) for p in (args.patterns or "10,1000,100000").split(",")]
    colds = [float(c) for c in (args.colds or "0.01,0.1,1.0").split(",")]
    algorithms = args.algorithms.split(",")

    log(f"[sweep] ensuring text+blob for {text_size} bp")
    ensure_inputs(text_size)
    if any(a in DEVICE_ALGOS for a in algorithms):
        from sview_fmindex_tpu_torch.models.device_index import resolve_device

        # raises here, before any cell, without a card unless the CPU is named
        if resolve_device(args.device).type == "cuda":
            prebuild_kernel()

    rows, cells, failures = [], [], []
    for count in patterns:
        for cold in colds:
            for algo in algorithms:
                dropped = False
                if algo == "mmap" and not args.no_drop_caches:
                    dropped = drop_caches()
                cmd = [sys.executable, os.path.abspath(__file__), "--cell",
                       "--text-size", str(text_size), "--patterns", str(count),
                       "--cold", str(cold), "--algorithm", algo,
                       "--serve-batches", str(args.serve_batches)]
                if args.device:
                    cmd += ["--device", args.device]
                t0 = time.time()
                proc = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO)
                cell = parse_cell(proc)
                if cell is None:
                    log(f"[sweep] FAIL {count}/{cold}/{algo} (exit {proc.returncode}): "
                        f"{proc.stderr[-1500:]}{proc.stdout[-300:]}")
                    failures.append((count, cold, algo))
                    continue
                load_pct = 100 * cell["load_ns"] // max(cell["total_ns"], 1)
                rows.append((count, cold, algo, cell["total_ns"], load_pct,
                             cell["max_rss_kb"]))
                cells.append({"pattern_count": count, "cold_ratio": cold,
                              "algorithm": algo, **cell})
                ph_s = " ".join(f"{k[:-3]}={v/1e9:.3f}s" for k, v in cell["phases"].items())
                src = cell["max_rss_source"]
                note = "" if src == "VmHWM" else ", which may hold the sweep's own"
                log(f"[sweep] {count:>7} cold={cold:<5} {algo:<7} "
                    f"total={cell['total_ns']/1e9:8.2f}s load={load_pct:2d}% "
                    f"query={cell['query_ns']/1e9:.4f}s "
                    f"rss={cell['max_rss_kb']/1024:7.0f}MB ({src}{note}) "
                    f"(wall {time.time()-t0:.0f}s, dropped_caches={dropped}; {ph_s})")

    fresh = {(r[0], r[1], r[2]) for r in rows}
    kept = write_csv(target, rows, bool(args.merge_into),
                     lambda c, cr, a: (c, cr, a) not in fresh)
    log(f"[sweep] wrote {target} ({len(rows)} fresh rows, {kept} kept)")
    if args.phases_out:
        with open(args.phases_out, "w") as f:
            json.dump(cells, f, indent=1)
        log(f"[sweep] wrote per-cell phase breakdowns to {args.phases_out}")
    if failures:
        sys.exit(f"[sweep] {len(failures)} cell(s) failed: {failures}")


if __name__ == "__main__":
    main()
