#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Drives the port's main path once, at the headline deployment that
``bench.py`` builds: a 20-bp DNA index (sigma=4, u32 positions,
Block3<u64>, SA sampling 2, k-mer LUT 3) over ``SMOKE_TEXT_SIZE`` bp
(default 1e8, chromosome scale; the same seed-42 ACGT generator as the
bench), uploaded with ``to_device_torch(fm, "cuda", dense_lut_entries=1<<28,
dense_host_entries=1<<20, sa_full="device", sa_fill_ratio=4)`` and queried
with uniform 20-bp batches of 100k and 1M patterns through ``count`` and
``locate_with_counts(use_stream=True)``.  Then the same blob through the wide
(u64-position) engine and through the stream-decode LF walk.

Phases, each printing its lines; any failure raises and exits non-zero:

1. device: a CUDA device is required (there is no CPU path); prints the
   card's name and power limit as ``nvidia-smi`` reports them.
2. build: compiles the join kernel from ``sview_fmindex_tpu_torch/csrc``.
3. main path: blob (native SA-IS, cached under ``bench_cache/``), upload
   (seconds per phase), the filled SA checked against the blob's sampled SA,
   then per batch: counts, locate, ``dropped == 0``, 200 locations against
   the raw text, the gather-engine parity gate, 1000 patterns against the
   host ``FmIndex``, and queries/s from CUDA events (best and worst of 5
   windows).  The kernel launch counters are zeroed just before the upload
   and read just after the last query: both join modes must have launched.
4. kernel: the join kernel against its plain-torch version on the main
   path's sigma=4 stream table and sigma^2=16 pair table, at 2M sorted keys
   (one B=1M search pass) including the key of the sentinel row and key n;
   results must be exactly equal.  Prints both times.
5. wide: the main-path index is freed and the same blob is uploaded as a
   wide index (``force_wide=True``, dense_k 10 from the host, sampled SA),
   then the main path's batches go through the wide stream engine with the
   same checks (wide-gather parity), and its counts and per-pattern location
   sets must equal the main path's.  Counters are zeroed before the upload:
   the segmented rank and decode modes must have launched.
6. walk: the blob uploaded narrow with the sampled SA (no full SA), the
   B=100k batch located with ``use_stream=True``: the LF walk decodes
   through the decode mode, whose counter must rise, and the location sets
   must equal the main path's.
7. segmented kernel: the segmented modes against their plain version on a
   seeded synthetic sigma=4 table of 2^25 + 2^20 rows (3 segments, keys
   beyond 2^32), 2M sorted keys including both sides of each segment
   boundary, 2^32 - 1, 2^32, 2^32 + 1, the last key in the table and one
   beyond it; exactly equal.  Prints both times.
8. opt-in, with ``SMOKE_WIDE_TEXT_SIZE`` (> 2^32, e.g. 4.3e9): a u64 blob
   over that many bp (seed 42, built and cached under ``bench_cache/``) is
   uploaded without ``force_wide`` and put through phase 5's checks with
   half the patterns starting above 2^32; some located positions must be
   >= 2^32.  Off by default: the host build takes long and needs ~19
   bytes of host memory per bp, more than a 96 GiB host has at 4.3e9.

The last lines are the kernel summary (JSON), the ``nvidia-smi`` line, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

T_START = time.time()
TEXT_SIZE = int(float(os.environ.get("SMOKE_TEXT_SIZE", "1e8")))
WIDE_TEXT_SIZE = int(float(os.environ.get("SMOKE_WIDE_TEXT_SIZE", "0")))
SEED = 42
PATTERN_LEN = 20
BATCHES = (100_000, 1_000_000)
WALK_BATCH = 100_000
N_ORACLE = 1000
N_RECHECK = 200
CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bench_cache")
KERNEL_KEYS = 1 << 21
SEG_ROWS = (1 << 25) + (1 << 20)  # 3 segments of 2^24 rows; keys reach 2^32 + 2^27
DEVICE = "cuda"
JOIN_SRC = "sview_fmindex_tpu_torch/csrc/join.cu"
JOIN_TPU = "sview_fmindex_tpu/ops/stream_join.py:297"


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def device_phase(torch) -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's smoke run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)
    return smi


def build_phase() -> None:
    from sview_fmindex_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.join_lib()
    secs, out = kernels.BUILD_LOG.get("join", (0.0, ""))
    regs = [ln.strip() for ln in out.splitlines() if "registers" in ln or "spill" in ln]
    log(f"[build] join kernel ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {secs:.2f} s): {'; '.join(regs)}")


def get_text(size: int) -> np.ndarray:
    """uint8 [size] ACGT text from seed 42: the bench's generator up to
    2^31 bp, larger texts in 2^28-byte chunks (bounded host memory)."""
    path = os.path.join(CACHE_DIR, f"text_{size}_{SEED}.bin")
    if not os.path.exists(path):
        rng = np.random.default_rng(SEED)
        acgt = np.frombuffer(b"ACGT", np.uint8)
        os.makedirs(CACHE_DIR, exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        if size <= 2**31:
            acgt[rng.integers(0, 4, size=size)].tofile(tmp)
        else:
            with open(tmp, "wb") as f:
                for a in range(0, size, 1 << 28):
                    acgt[rng.integers(0, 4, size=min(1 << 28, size - a), dtype=np.uint8)].tofile(f)
        os.replace(tmp, path)
    return np.memmap(path, dtype=np.uint8, mode="r")


def get_blob(ft, text: np.ndarray, position: str = "u32"):
    size = text.shape[0]
    tag = "" if position == "u32" else f"_{position}"
    path = os.path.join(CACHE_DIR, f"index_{size}_{SEED}{tag}_b3u64_r2_k3.blob")
    if not os.path.exists(path):
        enc = ft.EncodingTable.from_symbols([b"A", b"C", b"G", b"T"])
        builder = ft.FmIndexBuilder(
            size, enc.symbol_count(), enc, position=position, block=ft.BLOCK3_U64,
            suffix_array_config=ft.SuffixArrayConfig.compressed(2),
            lookup_table_config=ft.LookupTableConfig.kmer_size(3),
            sa_backend="native")
        # the host build peaks near 19 bytes per bp (int64 SA and its
        # shifted copy; two int64 text copies in the k-mer pass)
        avail = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_AVPHYS_PAGES")
        log(f"[blob] building the {position} blob over {size} bp "
            f"({avail / 2**30:.1f} GiB of host memory free)")
        t0 = time.perf_counter()
        tmp = f"{path}.tmp{os.getpid()}"
        # built straight into the file: no second copy of the blob in memory
        out = np.memmap(tmp, dtype=np.uint8, mode="w+", shape=(builder.blob_size(),))
        builder.build(text, blob=out)
        out.flush()
        del out
        os.replace(tmp, path)
        log(f"[blob] built the {position} blob over {size} bp in "
            f"{time.perf_counter() - t0:.1f} s ({os.path.getsize(path) / 2**20:.0f} MiB)")
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    return ft.FmIndex.load(mm, position=position, block=ft.BLOCK3_U64, encoder_kind="table")


def measure(fn, B: int, reps: int, windows: int = 5):
    """Queries/s per window, from CUDA events around ``reps`` back-to-back
    calls (after one warm call)."""
    from sview_fmindex_tpu_torch.bench import timing

    return [B / timing.timeit(fn, reps=reps)[1] for _ in range(windows)]


def location_sets(locs, pids, valid, n: int) -> np.ndarray:
    """Every pattern's located positions as one sorted array of
    ``pid * (n + 1) + loc``: equal arrays <=> equal per-pattern sets."""
    import torch

    return torch.sort(pids[valid] * (n + 1) + locs[valid])[0].cpu().numpy()


def check_batch(torch, fm, dev, text, pats_np, patterns, counts, out) -> None:
    locs, pids, valid, counts2, dropped = out
    B = counts.shape[0]
    check(int(dropped[0]) == 0, "capacity overflow dropped hits")
    check(torch.equal(counts, counts2), "locate_with_counts counts != count")
    check(bool((counts >= 1).all()), "a pattern taken from the text has count 0")
    check(int(valid.sum()) == int(counts.sum()), "valid slots != total count")
    locs_np, pids_np, valid_np = (t.cpu().numpy() for t in (locs, pids, valid))
    for i in np.nonzero(valid_np)[0][:N_RECHECK]:
        loc, p = int(locs_np[i]), int(pids_np[i])
        check(bytes(text[loc:loc + PATTERN_LEN]) == bytes(pats_np[p]),
              f"location {loc} does not hold pattern {p}")
    # parity gate: the gather engine must agree exactly
    c_g = dev.count(patterns, use_stream=False, use_pair=False)
    check(torch.equal(c_g, counts), "count parity (stream vs gather)")
    lg, pg, vg, _ = dev.locate(patterns, capacity=locs.shape[0], use_stream=False,
                               use_pair=False)
    check(torch.equal(vg, valid) and torch.equal(lg[vg], locs[valid])
          and torch.equal(pg[vg], pids[valid]), "locate parity (stream vs gather)")
    # host oracle
    counts_np = counts.cpu().numpy()
    by_pid: dict[int, list[int]] = {}
    for loc, p in zip(locs_np[valid_np], pids_np[valid_np]):
        if p < N_ORACLE:
            by_pid.setdefault(int(p), []).append(int(loc))
    for i in range(min(N_ORACLE, B)):
        pat = bytes(pats_np[i])
        check(int(counts_np[i]) == fm.count(pat), f"count of pattern {i} vs host")
        check(sorted(by_pid.get(i, [])) == sorted(fm.locate(pat)),
              f"locations of pattern {i} vs host")


def upload(torch, ft, fm, tag: str, **kwargs):
    """Upload and log seconds per phase and device memory."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dev = ft.to_device_torch(fm, DEVICE, **kwargs)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    phases = ", ".join(f"{k} {v:.2f}" for k, v in dev.upload_phases.items())
    log(f"[{tag}] upload {upload_s:.2f} s ({phases}); wide={dev.meta.wide_pos}, "
        f"dense_k={dev.meta.dense_k}, pair={dev.meta.pair_rows > 0}, "
        f"sa_full={dev.meta.has_sa_full}; resident "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return dev


def run_batch(torch, fm, dev, text, tag: str, pats_np, engine: str):
    """One batch through count + locate_with_counts(use_stream=True): every
    check, then queries/s.  Returns (counts, location sets, the locate
    output, seconds after start when the first call had answered)."""
    from sview_fmindex_tpu_torch.ops.locate import expand_capacity

    B = pats_np.shape[0]
    patterns = torch.from_numpy(pats_np).to(DEVICE)
    check(dev.engine_for(B, use_stream=True) == engine, f"engine is not {engine}")
    t0 = time.perf_counter()
    counts = dev.count(patterns, use_stream=True)
    capacity = expand_capacity(counts.cpu().numpy())
    out = dev.locate_with_counts(patterns, capacity=capacity, use_stream=True)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    answered_at = time.time() - T_START
    check_batch(torch, fm, dev, text, pats_np, patterns, counts, out)
    reps = max(8, min(32, int(4e6 // B)))
    cq = measure(lambda: dev.count(patterns, use_stream=True), B, reps)
    lq = measure(lambda: dev.locate_with_counts(
        patterns, capacity=capacity, use_stream=True), B, reps)
    log(f"[{tag}] B={B}: checks OK (dropped 0, {N_RECHECK} text re-checks, gather "
        f"parity, {N_ORACLE} host-oracle patterns); first call {warm_s:.3f} s; "
        f"count {max(cq) / 1e6:.3f} Mq/s (worst window {min(cq) / 1e6:.3f}), "
        f"locate {max(lq) / 1e6:.3f} Mq/s (worst window {min(lq) / 1e6:.3f}); "
        f"{int(counts.sum())} hits, capacity {capacity}")
    locs, pids, valid = out[:3]
    return counts.cpu().numpy(), location_sets(locs, pids, valid, fm.text_len), out, answered_at


def main_path(torch, ft) -> dict:
    from sview_fmindex_tpu_torch.ops import stream_join as sj
    from sview_fmindex_tpu_torch.ops.rank import u32

    text = get_text(TEXT_SIZE)
    t0 = time.perf_counter()
    fm = get_blob(ft, text)
    log(f"[main] text {TEXT_SIZE} bp, blob ready in {time.perf_counter() - t0:.1f} s")

    sj.LAUNCHES.clear()
    dev = upload(torch, ft, fm, "main", dense_lut_entries=1 << 28,
                 dense_host_entries=1 << 20, sa_full="device", sa_fill_ratio=4)
    r = fm.sampling_ratio
    check(torch.equal(u32(dev.sa[::r]), torch.tensor(fm.suffix_array.astype(np.int64),
                                                      device=DEVICE)),
          "filled SA != the blob's sampled SA at the sampled rows")
    log(f"[main] SA fill check: {fm.suffix_array.shape[0]} sampled rows OK")

    rng = np.random.default_rng(SEED + 1)
    first_query_s = None
    batches = {}
    for B in BATCHES:
        starts = rng.integers(0, TEXT_SIZE - PATTERN_LEN, size=B)
        pats_np = np.ascontiguousarray(text[starts[:, None] + np.arange(PATTERN_LEN)])
        counts, sets, _, answered_at = run_batch(torch, fm, dev, text, "main", pats_np,
                                                 "pair-stream")
        if first_query_s is None:
            first_query_s = answered_at
        batches[B] = dict(pats=pats_np, counts=counts, sets=sets)
    launches = dict(sj.LAUNCHES)
    log(f"[main] kernel launches on the main path: {launches}; "
        f"first query {first_query_s:.1f} s after start")
    check(launches.get("rank", 0) > 0, "rank-mode join kernel never launched")
    check(launches.get("decode", 0) > 0, "decode-mode join kernel never launched")
    return dict(fm=fm, text=text, dev=dev, launches=launches, batches=batches)


def time_join(torch, join_fn, plain_fn, args) -> dict:
    """Kernel and plain times in turns (kernel, plain, plain, kernel), 20
    launches each, CUDA events."""
    times = {}
    for label, fn in (("ms", join_fn), ("plain_ms", plain_fn),
                      ("plain_ms2", plain_fn), ("ms2", join_fn)):
        fn(*args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            fn(*args)
        end.record()
        end.synchronize()
        times[label] = start.elapsed_time(end) / 20
    return times


def kernel_case(torch, name, table, keys, payload, sigma, decode, launches, seg_base=None):
    """One join mode against its plain version: exact equality, then times."""
    from functools import partial

    from sview_fmindex_tpu_torch.ops import stream_join as sj

    join = partial(sj.join, seg_base=seg_base)
    plain = partial(sj.join_plain, seg_base=seg_base, seg_shift=sj._seg_shift())
    rk, sk = join(table, keys, payload, sigma, decode)
    rp, sp = plain(table, keys, payload, sigma, decode)
    torch.cuda.synchronize()
    err = int((rk - rp).abs().max())
    if decode:
        err = max(err, int((sk - sp).abs().max()))
    check(err == 0, f"{name} (sigma={sigma}) differs from its plain version by {err}")
    times = time_join(torch, join, plain, (table, keys, payload, sigma, decode))
    mode = ("decode" if decode else "rank") + ("" if seg_base is None else "_seg")
    log(f"[kernel] {name}: sigma={sigma} table {table.shape[0]}x{table.shape[1]}, "
        f"{keys.shape[0]} sorted keys (max {int(keys[-1])}): exact (max_abs_err 0); "
        f"kernel {times['ms']:.4f}/{times['ms2']:.4f} ms, plain "
        f"{times['plain_ms']:.4f}/{times['plain_ms2']:.4f} ms")
    return dict(name=name, route="cuda", source=JOIN_SRC, replaces=JOIN_TPU,
                launches=launches.get(mode, 0), max_abs_err=err,
                ms=min(times["ms"], times["ms2"]),
                plain_ms=min(times["plain_ms"], times["plain_ms2"]))


def kernel_phase(torch, dev, launches: dict) -> list[dict]:
    rng = np.random.default_rng(SEED + 2)
    n = int(dev.count_arr[-1])
    special = torch.tensor([0, dev.sentinel - 1, dev.sentinel, dev.sentinel + 1, n],
                           device=DEVICE)
    keys = torch.cat([special, torch.from_numpy(
        rng.integers(0, n + 1, size=KERNEL_KEYS - special.shape[0])).to(DEVICE)])
    keys = torch.sort(keys)[0]
    out = []
    for name, table, sigma, decode in (("join_rank", dev.pair_tbl, 16, False),
                                       ("join_decode", dev.stream_tbl, 4, True)):
        payload = None if decode else torch.from_numpy(
            rng.integers(0, sigma, size=KERNEL_KEYS)).to(DEVICE)
        out.append(kernel_case(torch, name, table, keys, payload, sigma, decode, launches))
    return out


def wide_checks(torch, ft, fm, text, tag: str, batches: dict, **upload_kw) -> dict:
    """Upload ``fm`` as a wide index and put every batch through run_batch
    on the wide stream engine; where ``batches`` carries the main path's
    answers, the wide ones must equal them.  Returns the launch counts."""
    from sview_fmindex_tpu_torch.ops import stream_join as sj

    sj.LAUNCHES.clear()
    dev = upload(torch, ft, fm, tag, dense_lut_entries=1 << 28,
                 dense_host_entries=1 << 20, **upload_kw)
    check(dev.meta.wide_pos and dev.meta.dense_k == 10 and not dev.meta.has_sa_full,
          "not a wide index with host dense seeds (dk 10) and a sampled SA")
    for B, want in batches.items():
        counts, sets, out, _ = run_batch(torch, fm, dev, text, tag, want["pats"], "wide-stream")
        if "counts" in want:
            check(np.array_equal(counts, want["counts"]), "wide counts != narrow counts")
            check(np.array_equal(sets, want["sets"]), "wide location sets != narrow ones")
            log(f"[{tag}] B={B}: counts and per-pattern location sets equal the main path's")
        else:
            locs, _, valid = out[:3]
            above = int((locs[valid] >= 2**32).sum())
            log(f"[{tag}] B={B}: {above} of {int(valid.sum())} located positions are >= 2^32")
            check(above > 0, "no located position at or above 2^32")
    launches = dict(sj.LAUNCHES)
    log(f"[{tag}] kernel launches: {launches}")
    check(launches.get("rank_seg", 0) > 0, "segmented rank mode never launched")
    check(launches.get("decode_seg", 0) > 0, "segmented decode mode never launched")
    check(not launches.get("rank") and not launches.get("decode"),
          "a wide index launched a narrow join mode")
    del dev
    torch.cuda.empty_cache()
    return launches


def walk_phase(torch, ft, fm, text, main: dict) -> dict:
    from sview_fmindex_tpu_torch.ops import stream_join as sj

    sj.LAUNCHES.clear()
    dev = upload(torch, ft, fm, "walk", dense_lut_entries=1 << 28, dense_host_entries=1 << 20)
    check(not dev.meta.has_sa_full, "the walk phase needs the sampled SA")
    want = main["batches"][WALK_BATCH]
    counts, sets, _, _ = run_batch(torch, fm, dev, text, "walk", want["pats"], "pair-stream")
    check(np.array_equal(counts, want["counts"]), "walk counts != main path counts")
    check(np.array_equal(sets, want["sets"]), "walk location sets != main path ones")
    launches = dict(sj.LAUNCHES)
    log(f"[walk] B={WALK_BATCH}: counts and location sets equal the main path's; "
        f"kernel launches: {launches}")
    check(launches.get("decode", 0) > 0, "the walk never launched the decode mode")
    del dev
    torch.cuda.empty_cache()
    return launches


def segmented_kernel_phase(torch, launches: dict) -> list[dict]:
    from sview_fmindex_tpu_torch.ops import stream_join as sj

    sigma = 4
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    table = torch.randint(-2**31, 2**31, (SEG_ROWS, sj._rw(sigma)), generator=g,
                          device=DEVICE).to(torch.int32)
    # local checkpoints are counts below 2^31
    table[:, :sigma] = torch.randint(0, 2**31, (SEG_ROWS, sigma), generator=g,
                                     device=DEVICE).to(torch.int32)
    n_segs = -(-SEG_ROWS // sj.SEG_BLOCKS)
    seg_base = torch.randint(0, 2**35, (n_segs, sigma), generator=g, device=DEVICE)
    end = SEG_ROWS * sj.SBL
    special = [0, 2**32 - 1, 2**32, 2**32 + 1, end - 1, end]
    for s in range(1, n_segs):
        b = s * sj.SEG_BLOCKS * sj.SBL
        special += [b - 1, b, b + 1]
    special = torch.tensor(special, device=DEVICE)
    keys = torch.cat([special, torch.randint(0, end + 1, (KERNEL_KEYS - special.shape[0],),
                                             generator=g, device=DEVICE)])
    keys = torch.sort(keys)[0]
    check(n_segs == 3 and int(keys[-1]) == end, "the synthetic table is not 3 segments")
    log(f"[kernel] segmented cases: {n_segs} segments of {sj.SEG_BLOCKS} rows, "
        f"table {table.numel() * 4 / 2**30:.2f} GiB")
    payload = torch.randint(0, sigma, (KERNEL_KEYS,), generator=g, device=DEVICE)
    out = [kernel_case(torch, "join_rank_seg", table, keys, payload, sigma, False,
                       launches, seg_base),
           kernel_case(torch, "join_decode_seg", table, keys, None, sigma, True,
                       launches, seg_base)]
    del table
    torch.cuda.empty_cache()
    return out


def wide_text_phase(torch, ft) -> None:
    """Opt-in: a u64 blob over WIDE_TEXT_SIZE bp, served without force_wide."""
    check(WIDE_TEXT_SIZE > 2**32 + 2**20, "SMOKE_WIDE_TEXT_SIZE must exceed 2^32")
    text = get_text(WIDE_TEXT_SIZE)
    t0 = time.perf_counter()
    fm = get_blob(ft, text, position="u64")
    log(f"[wide_text] text {WIDE_TEXT_SIZE} bp, u64 blob ready in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 4)
    batches = {}
    for B in BATCHES:
        # half the patterns start above 2^32
        starts = np.concatenate([
            rng.integers(0, WIDE_TEXT_SIZE - PATTERN_LEN, size=B // 2),
            rng.integers(2**32, WIDE_TEXT_SIZE - PATTERN_LEN, size=B - B // 2)])
        batches[B] = dict(pats=np.ascontiguousarray(
            text[starts[:, None] + np.arange(PATTERN_LEN)]))
    wide_checks(torch, ft, fm, text, "wide_text", batches)


def main() -> None:
    import torch

    smi = device_phase(torch)
    import sview_fmindex_tpu_torch as ft

    build_phase()
    main_res = main_path(torch, ft)
    kernels = kernel_phase(torch, main_res.pop("dev"), main_res["launches"])
    torch.cuda.empty_cache()
    fm, text = main_res["fm"], main_res["text"]
    wide_launches = wide_checks(torch, ft, fm, text, "wide", main_res["batches"],
                                force_wide=True)
    walk_phase(torch, ft, fm, text, main_res)
    kernels += segmented_kernel_phase(torch, wide_launches)
    if WIDE_TEXT_SIZE:
        wide_text_phase(torch, ft)
    check("jax" not in sys.modules, "the port imported JAX")
    log(f"[done] {time.time() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
