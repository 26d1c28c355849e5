"""One run of one benchmark cell of ``sview_fmindex_tpu_torch`` on one card.

    python3 fmbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``fmbench/configs/<config>.json``) and a traffic mix
(``fmbench/traffic/<mix>.json``); each metric the cell reports has a reader
``fmbench/metrics/<metric>.py``.  Set-up, all of it in ``setup_s``: import
the port, make the text from the seed, build the blob in memory, upload it,
draw the pool of batches, and call each batch once.  Then the window: one
caller sends the pool's batches in turn through the port's public query API
for ``--seconds`` seconds (``--trace 1``: ``TRACE_CYCLES`` cycles of the
pool under ``torch.profiler``).  After it, the program's answers are judged
against the plain reference (``reference.py``, ``judge.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` in a
traced run), then ``checks``: each number compared beside its limit, which
also end standard error.  Everything else goes to standard error and to
``fmbench/runs/``.

Without a CUDA device (or with fewer than the cell asks for) the run exits
2 and prints no result.  ``--device cpu`` runs the same program on the CPU
with the plain versions of the kernels, for the tests; its numbers are not
a card's.  ``--text-size`` and ``--batch`` shrink a cell for such a run.
``--control`` also judges the control (the reference matching only a seed
of each pattern) and prints its readings; the benchmark's own runs do not
run it.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# modules that must not be loaded in the measured process: JAX and the JAX
# package (top-level names compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "sview_fmindex_tpu")
RUNS_DIR = os.path.join(HERE, "runs")
# each batch's compared answer is its answer in a cycle of the pool drawn
# from the seed among the first KEEP_CYCLES; a traced window is TRACE_CYCLES
# cycles of the pool
KEEP_CYCLES = 4
TRACE_CYCLES = 2


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def metric_reader(name: str):
    """The module ``fmbench/metrics/<name>.py``: ``read(run)`` returns the
    metric or None; an optional ``probe(run)`` runs on the live index after
    the window of a traced run."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "fmbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell: str, reported: set) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    list, else every cell that reports the metric it ``moves``, else all."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in reported
    return True


def smi(device) -> str | None:
    """Clocks, power and limit of the card, read beside the window."""
    import torch

    try:
        uuid = torch.cuda.get_device_properties(device).uuid
        return subprocess.run(
            ["nvidia-smi", "-i", f"GPU-{uuid}",
             "--query-gpu=name,clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=20).stdout.strip()
    except (AttributeError, OSError, subprocess.SubprocessError):
        return None


class Run:
    """Everything one run learns; the metric readers take it."""

    def __init__(self, args, cell: dict, config: dict, mix: dict):
        self.args, self.cell, self.config, self.mix = args, cell, config, mix
        self.op = mix["op"]
        self.clocks: dict = {}
        self.details: dict = {"workload": cell["name"], "seed": args.seed}
        self.latencies: list = []
        self.patterns_done = 0
        self.window_s = 0.0
        self.trace = None
        self.probes: dict = {}
        self.device = None
        self.dev = None
        self.fm = None
        self.pool = None

    def generator(self, stream: int):
        """A numpy generator of its own for each use of the seed: 0 the
        text, 1 the traffic, 2 the compared sample, 3 the probes."""
        import numpy as np

        return np.random.default_rng(np.random.SeedSequence(
            self.args.seed & (2**64 - 1), spawn_key=(stream,)))


def call_fn(run):
    dev = run.dev
    if run.op == "locate":
        return lambda pats, lens: dev.locate_with_counts(pats, lens)
    if run.op == "count":
        return lambda pats, lens: dev.count(pats, lens)
    raise ValueError(f"unknown op {run.op!r}")


def to_host(out):
    if isinstance(out, tuple):
        return tuple(t.cpu() for t in out)
    return out.cpu()


def window(run, keep_cycle: list, calls: int | None, seconds: float):
    """The closed loop: one caller, each call started when the last one
    returned.  Returns each pool batch's kept answer."""
    import torch

    from fmbench.tracing import CALL, WINDOW

    fn = call_fn(run)
    cuda = run.device.type == "cuda"
    copy = bool(run.mix.get("to_host"))
    traced = calls is not None
    span = torch.profiler.record_function if traced else (lambda name: contextlib.nullcontext())
    kept = [None] * len(run.pool)
    lat = []
    P = len(run.pool)
    if cuda:
        torch.cuda.synchronize(run.device)
    t_start = t_end = time.perf_counter()
    # set-up is everything from the start of the script to here
    run.clocks["setup_s"] = t_start - T_START
    i = 0
    with span(WINDOW):
        while True:
            slot, cycle = i % P, i // P
            pats, lens = run.pool[slot]
            t0 = time.perf_counter()
            with span(CALL):
                out = fn(pats, lens)
                if copy:
                    out = to_host(out)
                elif cuda:
                    torch.cuda.synchronize(run.device)
            t_end = time.perf_counter()
            lat.append(t_end - t0)
            if cycle <= keep_cycle[slot]:
                kept[slot] = out
            run.patterns_done += pats.shape[0]
            i += 1
            # an untraced window lasts its seconds, and at least one cycle
            # of the pool, so every batch is answered in it
            if (i >= calls) if traced else (t_end - t_start >= seconds and i >= P):
                break
    run.window_s = t_end - t_start
    run.latencies = lat
    return kept


def setup(run):
    """Everything before the window, all of it in ``setup_s``."""
    import numpy as np
    import torch

    args, cfg, mix = run.args, run.config, run.mix
    t = time.perf_counter()
    import sview_fmindex_tpu_torch as ft

    # torch was imported first, to look for the card: both imports count
    run.clocks["import_s"] = run.clocks.pop("torch_import_s") + time.perf_counter() - t
    t = time.perf_counter()
    from fmbench import textgen

    size = args.text_size or int(float(cfg["text_size"]))
    text = textgen.make_text(cfg["text"], size, run.generator(0))
    run.text = text
    run.clocks["text_s"] = time.perf_counter() - t

    t = time.perf_counter()
    enc_spec = cfg["encoding"]
    groups = [g.encode() for g in enc_spec["symbols"]]
    enc = (ft.EncodingTable.from_symbols_with_wildcard(groups) if enc_spec.get("wildcard")
           else ft.EncodingTable.from_symbols(groups))
    block = getattr(ft, cfg["block"])
    builder = ft.FmIndexBuilder(
        size, enc.symbol_count(), enc, position=cfg["position"], block=block,
        suffix_array_config=ft.SuffixArrayConfig.compressed(int(cfg["sa_sampling"])),
        lookup_table_config=ft.LookupTableConfig.kmer_size(int(cfg["kmer_size"])),
        sa_backend="native")
    blob = np.empty(builder.blob_size(), np.uint8)
    builder.build(text, blob=blob)
    run.fm = ft.FmIndex.load(blob, position=cfg["position"], block=block, encoder_kind="table")
    run.clocks["build_s"] = time.perf_counter() - t
    run.details["blob_bytes"] = int(blob.shape[0])

    t = time.perf_counter()
    run.dev = ft.to_device_torch(run.fm, run.device, **cfg["upload"])
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    run.clocks["upload_wall_s"] = time.perf_counter() - t
    run.details["upload_phases"] = dict(run.dev.upload_phases)

    t = time.perf_counter()
    from fmbench import traffic

    if args.batch:
        mix = dict(mix, batch=args.batch)
        run.mix = mix
    run.pool = traffic.make_pool(text, mix, run.generator(1))
    run.clocks["pool_s"] = time.perf_counter() - t

    # one call of every batch of the pool: every shape the window sends,
    # every kernel built and loaded
    from sview_fmindex_tpu_torch.ops import stream_join

    t = time.perf_counter()
    fn = call_fn(run)
    before = stream_join.LAUNCHES_BY_SIGMA.copy()
    for pats, lens in run.pool:
        out = fn(pats, lens)
        if mix.get("to_host"):
            to_host(out)
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    now = stream_join.LAUNCHES_BY_SIGMA
    run.details["launches_per_call"] = {
        f"{m}@{s}": (now[m, s] - before[m, s]) / len(run.pool)
        for m, s in sorted(now) if now[m, s] > before[m, s]}
    run.details["engine"] = run.dev.engine_for(int(mix["batch"]))
    run.clocks["warm_s"] = time.perf_counter() - t


def judge(run, kept: list, control: bool):
    """Free the program's state, then hold the kept answers (and with
    ``control`` the control's) to the reference."""
    import torch

    from fmbench import judge as judge_mod
    from fmbench import reference

    hi = int(run.mix["lengths"][1])
    kept = [None if k is None else to_host(k) for k in kept]
    run.dev = run.fm = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = reference.ExactIndex(torch.from_numpy(run.text), run.config["encoding"], hi,
                               run.device)
    n = ref.n
    verdict = judge_mod.Verdict(run.op)
    ctrl = judge_mod.Verdict(run.op) if control else None
    prefix = int(run.config["control_prefix"]) if control else None
    for (pats, lens), out in zip(run.pool, kept):
        want = ref.answer(pats, lens)
        verdict.add(want, out, n, run.device)
        if ctrl is not None:
            counts, pid, pos = ref.answer(pats, lens, prefix=prefix)
            if run.op == "count":
                got = counts
            else:
                valid = torch.ones_like(pid, dtype=torch.bool)
                got = (pos, pid, valid, counts, torch.zeros(1, dtype=torch.int64))
            ctrl.add(want, got, n, run.device)
    run.clocks["reference_s"] = time.perf_counter() - t
    return verdict, ctrl


def traced_window(run, keep_cycle: list):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fmbench import tracing

    calls = TRACE_CYCLES * len(run.pool)
    acts = [ProfilerActivity.CPU]
    if run.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        kept = window(run, keep_cycle, calls, 0.0)
    os.makedirs(RUNS_DIR, exist_ok=True)
    path = os.path.join(RUNS_DIR, f"{run.cell['name']}.trace.json")
    t = time.perf_counter()
    prof.export_chrome_trace(path)
    run.trace = tracing.load(path, calls)
    run.clocks["trace_read_s"] = time.perf_counter() - t
    run.details["trace_file"] = os.path.relpath(path, ROOT)
    del prof
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    return kept


def run_cell(args) -> tuple[int, dict | None]:
    """(exit code, result or None)."""
    bench = load_json(ROOT, "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        log(f"[fmbench] no workload {args.workload!r} in BENCHMARK.json")
        return 2, None
    cell = cells[args.workload]
    config = load_json(HERE, "configs", f"{cell['config']}.json")
    mix = load_json(HERE, "traffic", f"{cell['traffic']}.json")
    run = Run(args, cell, config, mix)

    t = time.perf_counter()
    import torch

    run.clocks["torch_import_s"] = time.perf_counter() - t

    if args.device == "cpu":
        run.device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            log(f"[fmbench] the cell needs {cell['chips']} CUDA device(s); "
                f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                f"device_count={torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2, None
        run.device = torch.device("cuda", 0)
        torch.cuda.set_device(run.device)
        torch.cuda.reset_peak_memory_stats(run.device)
    log(f"[fmbench] {cell['name']}: config {cell['config']}, traffic {cell['traffic']}, "
        f"seed {args.seed}, device {run.device}")

    setup(run)
    log("[fmbench] setup: " + ", ".join(f"{k} {v:.3f}" for k, v in run.clocks.items())
        + f"; upload phases {run.details['upload_phases']}; engine {run.details['engine']}; "
        f"launches per call {run.details['launches_per_call']}")
    keep_rng = run.generator(2)
    trace = bool(args.trace)
    keep_cycle = keep_rng.integers(0, TRACE_CYCLES if trace else KEEP_CYCLES,
                                   size=len(run.pool)).tolist()
    cuda = run.device.type == "cuda"
    if cuda:
        run.details["smi_before"] = smi(run.device)
    if trace:
        kept = traced_window(run, keep_cycle)
    else:
        kept = window(run, keep_cycle, None, float(args.seconds))
    if cuda:
        run.details["smi_after"] = smi(run.device)
        run.memory_peak = int(torch.cuda.max_memory_allocated(run.device))
    else:
        run.memory_peak = 0
    run.details["latency_ms_quartiles"] = _quartiles_ms(run.latencies)
    log(f"[fmbench] setup_s {run.clocks['setup_s']:.3f}, window {run.window_s:.3f} s, "
        f"{len(run.latencies)} calls, "
        f"{run.patterns_done} patterns, latency quartiles "
        f"{run.details['latency_ms_quartiles']} ms; card {run.details.get('smi_after')}")

    # the readers: the cell's end-to-end metrics, or in a traced run its
    # per-layer metrics (their probes run here, on the live index)
    e2e = [m for m in bench["end_to_end"] if applies(m, cell["name"], set())]
    reported = {m["name"] for m in e2e}
    metrics = e2e if not trace else [m for m in bench["per_layer"]
                                     if applies(m, cell["name"], reported)]
    readers = {m["name"]: metric_reader(m["name"]) for m in metrics}
    if trace:
        for name, mod in readers.items():
            if hasattr(mod, "probe"):
                t = time.perf_counter()
                mod.probe(run)
                log(f"[fmbench] probe of {name}: {time.perf_counter() - t:.2f} s")

    verdict, ctrl = judge(run, kept, args.control)
    log(f"[fmbench] reference and comparison: {run.clocks['reference_s']:.2f} s, "
        f"{verdict.compared} patterns compared")

    values = {}
    for m in metrics:
        v = readers[m["name"]].read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
              "count": int(cell["chips"]) if cuda else 1,
              "memory_peak_bytes": run.memory_peak}
    result = {"correct": verdict.correct(), "attempted": run.patterns_done, "failed": 0,
              "metrics": values, "device": device}
    if trace:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    if ctrl is not None:
        result["control"] = {"correct": ctrl.correct(), "checks": ctrl.checks()}
    result["checks"] = verdict.checks()
    run.details.update(clocks=run.clocks, result=result, probes=run.probes)
    _write_details(run)
    return 0, result


def _quartiles_ms(lat: list):
    import statistics

    if len(lat) < 2:
        return None
    return [x * 1e3 for x in statistics.quantiles(lat, n=4)]


def _write_details(run) -> None:
    os.makedirs(RUNS_DIR, exist_ok=True)
    path = os.path.join(RUNS_DIR, f"{run.cell['name']}.seed{run.args.seed}"
                        f".trace{int(bool(run.args.trace))}.json")
    with open(path, "w") as f:
        json.dump(run.details, f, indent=1, default=str)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cpu",), default=None,
                    help="run on the CPU with the kernels' plain versions (tests only)")
    ap.add_argument("--text-size", type=int, default=None, help="tests only: a smaller text")
    ap.add_argument("--batch", type=int, default=None, help="tests only: a smaller batch")
    ap.add_argument("--control", action="store_true",
                    help="also judge the control, which must come out not correct")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    code, result = run_cell(args)
    if result is None:
        return code
    bad = forbidden_modules()
    if bad:
        log(f"[fmbench] the measured process loaded {bad}: no result")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
