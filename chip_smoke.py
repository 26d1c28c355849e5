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
(u64-position) engine and through the stream-decode LF walk, and two more
alphabets at the same size through the same entry points: protein (sigma
20) and DNA with a wildcard (sigma 5, a pair table of 25 codes).

Phases, each printing its lines; any failure raises and exits non-zero:

1. device: a CUDA device is required (there is no CPU path); prints the
   card's name and power limit as ``nvidia-smi`` reports them.
2. build: compiles the join kernel, the gather engine's search kernel and
   the LF walk's kernel from ``sview_fmindex_tpu_torch/csrc``; no
   instantiation may spill registers.
3. main path: blob (native SA-IS, cached under ``bench_cache/``), upload
   (seconds per phase), the filled SA checked against the blob's sampled SA
   and against a second fill from the same tables in slices of 2^20 chains
   (12 slices at 1e8 bp; the upload's 2^26-chain slice holds all 12.5M), equal
   tensor for tensor (seconds and device peak of both printed), then per
   batch: counts, locate, ``dropped == 0``, 200 locations against the raw
   text, the gather-engine parity gate, 1000 patterns against the host
   ``FmIndex``, and queries/s from CUDA events (best and worst of 5
   windows).  The kernel launch counters are zeroed just before the upload
   and read just after the last query: both join modes must have launched.
4. kernel: the join kernel against its plain-torch version on the main
   path's sigma=4 stream table and sigma^2=16 pair table, at 2M sorted keys
   (one B=1M search pass) including the key of the sentinel row and key n;
   results must be exactly equal.  Prints both times.  Three cases: rank on
   the pair table and decode on the stream table (the main path's launches),
   and rank on the stream table (``join_rank_sigma4``: the launch of the
   micro suite's ``rank`` group in phase 12, whose count it carries).
   Before them the gather engine's kernel (``csrc/gather_search.cu``: the
   seed and every LF step in one launch) against its plain version, the
   per-step loop on the card, at B = 4096 and 32767 20-bp windows of the
   main text: exactly equal, times in turns, the plain version's device
   launches a call, and its bound from the bytes the search needs.
5. wide: the main-path index is freed and the same blob is uploaded as a
   wide index (``force_wide=True``, dense_k 10 from the host, sampled SA),
   then the main path's batches go through the wide stream engine with the
   same checks (wide-gather parity), and its counts and per-pattern location
   sets must equal the main path's.  Counters are zeroed before the upload:
   the segmented rank and decode modes must have launched.
6. walk: the blob uploaded narrow with the sampled SA (no full SA), the
   B=100k batch located with ``use_stream=True``: the LF walk is the
   kernel ``csrc/lf_walk.cu``, whose launch counter must rise, and the
   location sets must equal the main path's.  Then the kernel against its
   plain version (``ops/locate.lf_walk`` decoding through the join's
   decode mode, the walk's path before the kernel) on an r = 32 index of the
   main text, as ``dna20-1e8-sa32`` keeps it (the upload's sampled SA taken
   every 16th entry): the B=1M batch's expand buffer, exactly equal, times
   in turns, the walk's counts from both under a profiler (equal), and the
   bound from the bytes of its work.
7. segmented kernel: the segmented modes against their plain version on a
   seeded synthetic sigma=4 table of 2^25 + 2^20 rows (3 segments, keys
   beyond 2^32), 2M sorted keys including both sides of each segment
   boundary, 2^32 - 1, 2^32, 2^32 + 1, the last key in the table and one
   beyond it; exactly equal.  Prints both times.  Then the main path's two
   modes on seeded synthetic tables of the 1 Gbp deployment's size, which
   miss L2 as every real index does: ``join_rank_hbm`` (sigma 16, 2^23 rows,
   1 GiB) and ``join_decode_hbm`` (sigma 4, 2^23 rows), 2M sorted keys each;
   the same two modes on 2^22-row tables whose checkpoint words all lie in
   [2^31, 2^32 - 2^24) (``join_rank_hi_ckpt``, ``join_decode_hi_ckpt``), as
   the tables of a narrow index between 2^31 and 2^32 bp hold them, and in
   [2^32 - 2^24, 2^32 - 2^8) (``join_rank_top_ckpt``, ``join_decode_top_ckpt``:
   the top of the u32 word, which no real uniform text reaches); and the
   SA fill's unfilled-row scan over 2^31 + 2^20 int32 words (8.6 GB), which
   must return exactly its 1000 planted rows.  Then the ragged-edge key sets of ``bench/join_cases.py`` (key counts off
   the warp and block size, keys outside the table inside a warp, one row
   for many keys, segment boundaries, unsorted keys) through kernel and plain
   version on the card, all four modes at sigma 4, 16 and 20, exactly equal.
8. protein (BASELINE config 4, the interop corpus case ``prot_b5u64_k2r2``
   at full size): ``SMOKE_TEXT_SIZE`` residues uniform over the 20 amino
   acids (seed 42), u32 positions, Block5<u64>, k=2, r=2, the main path's
   upload (dense_k 6, full SA filled through the sigma=20 decode mode),
   mixed 10-30 aa batches of 100k and 1M through the stream engine's
   per-step path with the main path's checks; the rank and decode modes
   must have launched at sigma 20.  The join kernel against its plain
   version on the sigma=20 table (rank, decode).  Then the same blob wide
   (``force_wide``, dense_k 4) at B=100k: its answers equal the narrow
   ones, and rank_seg and decode_seg launched at sigma 20 and are held
   against their plain version on the wide table.
9. wildcard DNA (the corpus case ``wild_b3u64_k3r2`` at full size): the
   main path's text with seeded N runs of 100-5000 bp over 1% of it,
   ``EncodingTable.from_symbols_with_wildcard`` over ACGT (sigma 5),
   Block3<u64>, k=3, r=2, the main path's upload (dense_k 12, pair table
   of 25 codes); 20-bp batches of 100k and 1M (4 pair passes) and a 21-bp
   batch of 100k (plus the odd pass over the sigma=5 table), 1% of each
   straddling an N run's edge, with the main path's checks; the kernel
   against its plain version at sigma 5 (rank, decode) and on the pair
   table (rank); then the same blob wide at B=100k.
10. parallel, one rank: a one-rank NCCL group in this process
   (``parallel.distributed.initialize``); ``ShardedFmIndex`` over the main
   path's index (run right after phase 3, while it is resident) serves the
   B=100k and B=1M batches (count, locate): answers equal to the unsharded
   ones, ``dropped == 0``, rates and the join launches of the phase (zeroed
   before, read after; the rank mode must have launched).  Then
   ``RangeShardedFmIndex`` over the same blob, with the sampled SA (the
   collective LF walk) and with ``sa_full`` (the device-filled SA copied to
   the host): the same checks, rates, and the share of a locate call spent
   in ``all_reduce`` (from a second, instrumented call); it launches no
   hand kernel.  Then the two wide steps of the JAX package's multichip dry
   run on the same 1e8 bp blob: ``RangeShardedFmIndex(..., force_wide=True)``
   with the walk (and ``sa_full`` refused, as there), and ``ShardedFmIndex``
   over ``to_device_torch(fm, force_wide=True)`` with ``use_stream=True``,
   which must launch the segmented rank mode; answers equal the narrow ones.
11. parallel, two ranks on the one card (last, when the card is empty): two
   child processes of this script, gloo (the ranks share a device), both on
   ``cuda:0``, over a ``SMOKE_PAR_TEXT_SIZE`` bp blob (default 1e7) and
   B=100k: ``ShardedFmIndex`` (each rank launches the join kernel on its
   half), ``RangeShardedFmIndex`` with ``rs=2`` (walk and ``sa_full``, then
   ``force_wide`` with the walk) and the ``(rs=2) x (dp=1)`` mesh; every
   rank compares with its own unsharded answers and checks that neither
   ``jax`` nor ``sview_fmindex_tpu`` was imported.  A child that fails or
   outlasts its deadline is killed and fails the run.
12. bench surfaces (after phase 9, before phase 11, on an empty card): the
   entry points that measure, each step failing the run if it raises, exits
   non-zero or prints a malformed line.  (0) a sigma-6 PassThrough index on
   the card is sent a batch with the symbol 6: ``ValueError`` before anything
   reaches the device, and the next query on the same CUDA context answers.
   (1) ``bench_torch.py`` as a subprocess at ``SMOKE_TEXT_SIZE`` (it reads
   the blob phase 3 cached): its one JSON line has every key, both batches,
   best and worst window per rate, printed beside phase 3's rates; its own
   launch counts show the decode mode in its upload and the rank mode at
   sigma 16 in one ``count`` and one ``locate`` call per batch.  (2)
   ``sview_fmindex_tpu_torch.bench.micro`` in this process, B = 1k..1M, every
   group, over an index with the main path's seed depth: every group has
   its rows, the rank mode launched in the ``rank`` and ``search`` groups
   (the suite itself holds the kernel's answers against ``join_plain`` and
   the gather engine once per B), and the ``search`` rows are printed as the
   gather-against-stream crossover table.  (3) the CLI end to end in a temporary directory at 1e6 bp, 1000
   patterns, cold 10%: ``generate-text``, ``generate-pattern``, ``build -a
   memory``, ``locate -a memory`` and ``locate -a device --serve 8``; the two
   result files are byte-identical.  (4) ``run_benchmark_torch.py
   --algorithms mmap,device --patterns 1000 --colds 0.1`` as a subprocess:
   exit 0, two CSV rows, the device cell's phases and launches printed.  (5)
   ``bench.scaling.run_scaling`` with one rank (NCCL, in this process) and two
   (gloo children on ``cuda:0``) at ``SMOKE_PAR_TEXT_SIZE``: a row for each,
   ``virtual`` true.  (6) ``tools/torch_scaling_report.py`` as a subprocess
   at ``SMOKE_PAR_TEXT_SIZE`` over 1 and 2 ranks: weak-scaling rows (25,000
   patterns a rank), the one-rank sharded overhead, and the communication
   model beside its measured two-process gloo floor.  (7)
   ``tools/torch_wide_bench.py`` as a subprocess at ``SMOKE_TEXT_SIZE``:
   parity ok, both engines' rates, and the segmented rank mode launched in
   its wide-stream calls.
13. opt-in, with ``SMOKE_WIDE_TEXT_SIZE`` (> 2^32; 4.5e9 is the size of the
   JAX package's record): a u64 blob over that many bp (seed 42, cached
   under ``bench_cache/``), built by a child process of this script that
   starts before phase 3 and runs beside the earlier phases; its peak RSS
   (``os.wait4``) is printed in GiB and bytes per bp.  The build needs about
   10 bytes of host memory per bp beside the text (the int64 SA, the padded
   text and the BWT, the SA-IS type array on top while it runs), 45 GB at
   4.5e9.  The blob is uploaded without ``force_wide`` and put through phase
   5's checks with half the patterns starting above 2^32 (some located
   positions must be >= 2^32); the segmented modes are held against their
   plain version on its real table (``join_rank_seg_u64``,
   ``join_decode_seg_u64``: sigma 4, 2M keys past 2^32, 3 segments).  The
   card is freed and ``tools/torch_wide_scale_check.py`` serves the same
   files range-sharded (one NCCL rank).  16 of that tool's patterns are
   found by scanning the raw text (``mmap.find``), an oracle that does not
   read the blob: the wide engine and the range-sharded answers must equal
   it.

14. card suite (after phase 12, before phase 11): the port's card tests,
   ``tests/test_torch_card_matrix.py`` (every interop corpus case from its
   blob and from a seeded 30-40 k symbol text, narrow and wide, every upload
   option, held to the CPU upload and the host oracle),
   ``tests/test_torch_corpus.py`` and ``tests/test_torch_kernels.py``, run
   with ``-m cuda --noconftest`` in a child pytest process.  Passed must
   equal collected; a failure, an error or a skip fails the run.  All four
   join modes must have launched in the matrix, and sigma 9, 24 and 40
   through an engine.  Prints a ``{"card_suite": ...}`` line: the counts,
   seconds per file and the matrix's launches by mode and ``mode@sigma``.

15. opt-in, with ``SMOKE_NARROW_TEXT_SIZE`` (in (2^31 + 2^20, 2^32); 3.1e9,
   a human genome, is the headline deployment's size, 4294967295 the largest
   u32 blob; not in one run with phase 13): a u32 blob at the main path's
   configuration over that many bp (the shared seed-42 text), built by a
   child process that starts before phase 3, as phase 13's, with per-pass
   times and its peak RSS.
   Uploaded as ``bench_torch.py`` uploads (``UPLOAD_KW``, no
   ``force_wide``): it must stay narrow; seconds and device peak per upload
   phase.  The SA fill ran in slices of ``build/sa_fill._FILL_CHAINS`` chains
   (its slices, live width and rounds printed), and its phase's device peak
   stays within ``sa_fill.fill_budget`` (the int32 SA plus one slice at
   ``CHAIN_BYTES`` a chain) above the memory resident before it.  The filled
   SA equals the blob's at every sampled row (in pieces), and 100k random
   adjacent rows hold their suffixes in strict order read from the raw text.
   B=100k and 1M (half the starts above 2^31) through the pair-stream engine
   with the main path's checks, rates on both clocks; located positions and
   range rows at and above 2^31 counted (some must be); 16 patterns (8 above
   2^31) against a scan of the raw text; the dense seed of T^dense_k, whose
   range ends at n, and a 20-bp pattern starting with it, against the scan;
   ``join_rank_pair_narrow_hi`` and ``join_decode_narrow_hi`` against their
   plain version on the real tables, half the keys above 2^31.  At sizes of
   2^32 - 2^24 and more, also: positions and range rows at or above 2^32 -
   2^24 counted (some must be), 4 of the 8 high scan patterns start there,
   and a third of the kernel keys lie in [n - 2^20, n].  Then the card is
   freed and the blob goes up again with its sampled SA: B=100k through the
   LF walk's kernel must answer as the full-SA upload did.

No earlier phase was cut in depth to make room for later ones: on an NVIDIA
H100 80GB HBM3 (700 W) phase 12 takes 70-235 s, phase 14 100-165 s, and
the whole 469-705 s, by how fast the host is; with phase 15 at 3.1e9 bp,
1062-1284 s (its build child alone 883-1094 s), at 2^32 - 1 bp 1414-1483 s
(the build child 1158-1230 s, 63.05 GiB of host memory).

The last lines are the kernel summary (JSON: per kernel its launches on the
main path, its time, the plain version's, and ``bound_ms``, the least time
the card could take for the same inputs, see :func:`join_bound`), the
``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

import bench_torch

T_START = time.time()
TEXT_SIZE = int(float(os.environ.get("SMOKE_TEXT_SIZE", "1e8")))
WIDE_TEXT_SIZE = int(float(os.environ.get("SMOKE_WIDE_TEXT_SIZE", "0")))
NARROW_TEXT_SIZE = int(float(os.environ.get("SMOKE_NARROW_TEXT_SIZE", "0")))
PAR_TEXT_SIZE = int(float(os.environ.get("SMOKE_PAR_TEXT_SIZE", "1e7")))
PAR_BATCH = 100_000
PAR_CHILD_DEADLINE = 420  # seconds for the two-rank run, start to exit
PAR_GROUP_TIMEOUT = 120  # seconds, every collective of every group
SURFACE_DEADLINE = 300  # seconds for one bench surface run as a subprocess
CARD_SUITE_DEADLINE = 600  # seconds for phase 14's pytest child
# phase 14: the port's card tests, and the alphabets no other phase sends
# through an engine, which the matrix must launch the kernel at
CARD_SUITE = ("tests/test_torch_card_matrix.py", "tests/test_torch_corpus.py",
              "tests/test_torch_kernels.py", "tests/test_torch_gather_search.py",
              "tests/test_torch_walk_kernel.py")
CARD_SUITE_SIGMAS = (9, 24, 40)
WIDE_SCALE_DEADLINE = 1800  # seconds for the scale check at 4.5e9: it stages 18 GB of SA
MICRO_BATCHES = "1000,4000,16000,65536,262144,1000000"
CLI_TEXT, CLI_PATTERNS, CLI_COLD = 1_000_000, 1000, 0.1
# queries/s per window of every run_batch, by (tag, B): {"count": [...], "locate": [...]}
RATES: dict = {}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
ALU_OPS_PER_S = 67e12  # its non-tensor-core rate (float32; the table has no int32 row)
SEED = 42
PATTERN_LEN = 20
BATCHES = (100_000, 1_000_000)
WALK_BATCH = 100_000
N_ORACLE = 1000
N_RECHECK = 200
CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bench_cache")
KERNEL_KEYS = 1 << 21
HEAD_START_CYCLES = 6_000_000  # ~3.5 ms of the card's clock before a timed run of launches
SEG_ROWS = (1 << 25) + (1 << 20)  # 3 segments of 2^24 rows; keys reach 2^32 + 2^27
HBM_ROWS = 1 << 23  # the tables of a 1 Gbp index: 2^30 positions / 128
# the narrow tables of an index between 2^31 and 2^32 bp hold checkpoint
# words of 2^31 and more: synthetic ones, 2^22 rows, in the default run
HI_CKPT_ROWS = 1 << 22
HI_CKPT = (2**31, 2**32 - 2**24)
# and, up to the largest word whose sum with a block's 128 positions still
# fits u32, the words no real uniform text reaches (they stay under ~n/4)
TOP_CKPT = (2**32 - 2**24, 2**32 - 2**8)
# phase 3's second fill of the main index, in slices of this many chains
GUARD_CHAINS = 1 << 20
# the SA fill's unfilled-row scan over more than INT_MAX words, 1000 planted
SCAN_ENTRIES, SCAN_PLANTED = 2**31 + 2**20, 1000
# phase 15: the opt-in narrow text lies in this open interval (2^32: the
# u32 blob's own limit)
NARROW_RANGE = (2**31 + 2**20, 2**32)
NARROW_HIGH = 2**31  # where a narrow table's words turn negative as int32
# at or above this size phase 15 also holds the values only the top of the
# u32 range has: keys, positions and rows at or above it
NARROW_TOP = 2**32 - 2**24
NARROW_TOP_KEYS = 2**20  # there the real-table kernel cases also draw from [n - this, n]
N_ORDER_PAIRS = 100_000  # adjacent SA rows whose suffixes are held in order
SA_CHECK_PIECE = 1 << 26  # sampled SA rows per piece of the SA fill check
RAGGED_ROWS, RAGGED_SEG_ROWS = 40, 8
DEVICE = "cuda"
JOIN_SRC = "sview_fmindex_tpu_torch/csrc/join.cu"
JOIN_TPU = "sview_fmindex_tpu/ops/stream_join.py:297"
GATHER_SRC = "sview_fmindex_tpu_torch/csrc/gather_search.cu"
# no TPU kernel: the JAX package's gather engine is jnp, fused by XLA under jit
GATHER_TPU = "none (sview_fmindex_tpu/ops/search.py:152 pos_ranges, jnp under jit)"
WALK_SRC = "sview_fmindex_tpu_torch/csrc/lf_walk.cu"
# no TPU kernel: the JAX package's walk is a jnp loop over the Pallas join decode
WALK_TPU = "none (sview_fmindex_tpu/ops/locate.py lf_walk, a jnp loop over the join decode)"
WALK_RATIO = 32  # the walk kernel's case: dna20-1e8-sa32's SA sampling
# the gather engine's kernel case: the serve-4k cell's batch, and the largest
# batch the engine serves by default (DeviceFmIndex.STREAM_MIN_BATCH - 1)
GATHER_BATCHES = (4096, 32767)
AMINO = b"ARNDCQEGHILKMFPSTWYV"
PROT_LENS = (10, 30)  # BASELINE config 4: mixed-length 10-30 aa patterns
WILD_LENS = (20, 21)  # 20 bp: 4 pair passes after dense_k 12; 21 bp: + the odd sigma=5 pass
WILD_N_SHARE = 0.01  # N runs of 100-5000 bp cover about 1% of the text
# (blob file prefix, block, k-mer LUT, SA sampling) per alphabet
ALPHABETS = {
    "dna": ("index", "BLOCK3_U64", 3, 2),
    "wild": ("wild", "BLOCK3_U64", 3, 2),  # interop corpus case wild_b3u64_k3r2
    "prot": ("prot", "BLOCK5_U64", 2, 2),  # prot_b5u64_k2r2, BASELINE config 4
}


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


def ptxas_report(out: str) -> list[str]:
    """One entry per compiled kernel from ``ptxas -v``: its template
    arguments, registers and spill bytes."""
    report, name, spill = [], "?", ""
    for ln in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            t = re.search(r"(join_kernel)ILi(\d+)ELb([01])ELb([01])E", m.group(1))
            g = re.search(r"(gather_search_kernel|lf_walk_kernel)ILi(\d+)ELi(\d+)E", m.group(1))
            name = (f"{t.group(1)}<P={t.group(2)},{'decode' if t.group(3) == '1' else 'rank'}"
                    f"{',seg' if t.group(4) == '1' else ''}>" if t
                    else f"{g.group(1)}<P={g.group(2)},LANES={g.group(3)}>" if g
                    else m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = f"spill {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            report.append(f"{name} {m.group(1)} regs {spill}".strip())
    return report


def build_phase() -> None:
    from sview_fmindex_tpu_torch import kernels

    for name, load in (("join", kernels.join_lib), ("gather_search", kernels.gather_search_lib),
                       ("lf_walk", kernels.lf_walk_lib)):
        t0 = time.perf_counter()
        load()
        if name not in kernels.BUILD_LOG:
            log(f"[build] {name} kernel loaded from an earlier build in _build/ (no compiler log)")
            continue
        secs, out = kernels.BUILD_LOG[name]
        report = ptxas_report(out)
        log(f"[build] {name} kernel ready in {time.perf_counter() - t0:.2f} s "
            f"(nvcc {secs:.2f} s), {len(report)} instantiations: {'; '.join(report)}")
        check(report and all(r.endswith("spill 0/0 B") for r in report),
              f"a {name} kernel instantiation spills registers")


def get_text(size: int) -> np.ndarray:
    """uint8 [size] ACGT text from seed 42, cached under ``bench_cache/``:
    the bench's generator (``bench_torch.get_text``), so the two scripts
    write one set of bytes under one name at every size."""
    return bench_torch.get_text(size, CACHE_DIR)


def _cached_text(name: str, make) -> np.ndarray:
    path = os.path.join(CACHE_DIR, name)
    if not os.path.exists(path):
        os.makedirs(CACHE_DIR, exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        make().tofile(tmp)
        os.replace(tmp, path)
    return np.memmap(path, dtype=np.uint8, mode="r")


def get_wild_text(size: int) -> np.ndarray:
    """The seed-42 ACGT text with seeded runs of N, 100-5000 bp long, over
    about 1% of it: the gaps of a genome assembly."""
    def make():
        text = np.array(get_text(size))
        rng = np.random.default_rng(SEED + 10)
        covered = 0
        while covered < WILD_N_SHARE * size:
            m = int(rng.integers(100, 5001))
            a = int(rng.integers(0, size - m))
            text[a:a + m] = ord("N")
            covered += m
        return text
    return _cached_text(f"text_wild_{size}_{SEED}.bin", make)


def get_protein_text(size: int) -> np.ndarray:
    """``size`` residues uniform over the 20 amino acids, seed 42."""
    return _cached_text(f"text_prot_{size}_{SEED}.bin", lambda: np.frombuffer(
        AMINO, np.uint8)[np.random.default_rng(SEED).integers(0, 20, size=size)])


def blob_path(size: int, position: str = "u32", alphabet: str = "dna") -> str:
    prefix, block_name, k, r = ALPHABETS[alphabet]
    tag = "" if position == "u32" else f"_{position}"
    return os.path.join(CACHE_DIR, f"{prefix}_{size}_{SEED}{tag}_"
                        f"{block_name.lower().replace('block', 'b').replace('_', '')}"
                        f"_r{r}_k{k}.blob")


def get_blob(ft, text: np.ndarray, position: str = "u32", alphabet: str = "dna"):
    _, block_name, k, r = ALPHABETS[alphabet]
    block = getattr(ft, block_name)
    size = text.shape[0]
    path = blob_path(size, position, alphabet)
    if not os.path.exists(path):
        if alphabet == "prot":
            enc = ft.EncodingTable.from_symbols([bytes([c]) for c in AMINO])
        elif alphabet == "wild":  # N and every other byte: a fifth symbol
            enc = ft.EncodingTable.from_symbols_with_wildcard([b"A", b"C", b"G", b"T"])
        else:
            enc = ft.EncodingTable.from_symbols([b"A", b"C", b"G", b"T"])
        builder = ft.FmIndexBuilder(
            size, enc.symbol_count(), enc, position=position, block=block,
            suffix_array_config=ft.SuffixArrayConfig.compressed(r),
            lookup_table_config=ft.LookupTableConfig.kmer_size(k),
            sa_backend="native")
        # the host build peaks near 10 bytes per bp beside the text (the
        # int64 SA, the padded text and the BWT; 6 with an int32 SA), with
        # the native SA-IS's type array (1 byte per bp) on top while it runs
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
    return ft.FmIndex.load(mm, position=position, block=block, encoder_kind="table")


def measure(fn, B: int, reps: int, windows: int = 5, clock: str = "events"):
    """Queries/s per window of ``reps`` back-to-back calls after one warm
    call (``bench.timing.window_rates``, the bench surfaces' idiom), read
    from CUDA events or, with ``clock="host"``, on the synchronised host
    clock: collectives staged through the host are not on the device's.
    ``clock=None``: both clocks' rates of the same windows."""
    from sview_fmindex_tpu_torch.bench import timing

    rates = timing.window_rates(fn, B, reps, windows, device=DEVICE)
    return rates if clock is None else rates[clock]


def location_sets(locs, pids, valid, n: int) -> np.ndarray:
    """Every pattern's located positions as one sorted array of
    ``pid * (n + 1) + loc``: equal arrays <=> equal per-pattern sets."""
    import torch

    return torch.sort(pids[valid] * (n + 1) + locs[valid])[0].cpu().numpy()


def check_batch(torch, fm, dev, text, pats_np, lens, patterns, counts, out) -> None:
    """Every check of one batch; ``lens`` int [B] (or None: all of
    ``pats_np``'s width)."""
    locs, pids, valid, counts2, dropped = out
    plen = np.full(pats_np.shape[0], pats_np.shape[1]) if lens is None else lens
    B = counts.shape[0]
    check(int(dropped[0]) == 0, "capacity overflow dropped hits")
    check(torch.equal(counts, counts2), "locate_with_counts counts != count")
    check(bool((counts >= 1).all()), "a pattern taken from the text has count 0")
    check(int(valid.sum()) == int(counts.sum()), "valid slots != total count")
    locs_np, pids_np, valid_np = (t.cpu().numpy() for t in (locs, pids, valid))
    for i in np.nonzero(valid_np)[0][:N_RECHECK]:
        loc, p = int(locs_np[i]), int(pids_np[i])
        check(bytes(text[loc:loc + plen[p]]) == bytes(pats_np[p, :plen[p]]),
              f"location {loc} does not hold pattern {p}")
    # parity gate: the gather engine must agree exactly
    c_g = dev.count(patterns, lens, use_stream=False, use_pair=False)
    check(torch.equal(c_g, counts), "count parity (stream vs gather)")
    lg, pg, vg, _ = dev.locate(patterns, lens, capacity=locs.shape[0], use_stream=False,
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
        pat = bytes(pats_np[i, :plen[i]])
        check(int(counts_np[i]) == fm.count(pat), f"count of pattern {i} vs host")
        check(sorted(by_pid.get(i, [])) == sorted(fm.locate(pat)),
              f"locations of pattern {i} vs host")


@contextlib.contextmanager
def phase_peaks(torch, peaks: dict, resident: dict):
    """Device peak memory per upload phase, into ``peaks``: at each phase
    end of ``DeviceFmIndex.from_host`` (``_PhaseClock``) torch's peak
    counter is read and reset; ``resident``: the memory allocated then."""
    from sview_fmindex_tpu_torch.models import device_index

    real = device_index._PhaseClock.__call__

    def call(clock, label):
        real(clock, label)
        peaks[label] = torch.cuda.max_memory_allocated()
        resident[label] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    device_index._PhaseClock.__call__ = call
    try:
        yield peaks
    finally:
        device_index._PhaseClock.__call__ = real


def upload(torch, ft, fm, tag: str, mem: dict | None = None, **kwargs):
    """Upload and log seconds and device peak memory per phase.  ``mem``:
    receives ``peaks`` and ``resident`` (bytes at each phase end) by phase."""
    torch.cuda.reset_peak_memory_stats()
    peaks, resident = {}, {}
    t0 = time.perf_counter()
    with phase_peaks(torch, peaks, resident):
        dev = ft.to_device_torch(fm, **kwargs)  # no device named: the card
    check(dev.device.type == DEVICE, f"the default upload landed on {dev.device}")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    peak = max([torch.cuda.max_memory_allocated(), *peaks.values()])
    phases = ", ".join(f"{k} {v:.2f} s, peak {peaks[k] / 2**30:.2f} GiB"
                       for k, v in dev.upload_phases.items())
    log(f"[{tag}] upload {upload_s:.2f} s ({phases}); wide={dev.meta.wide_pos}, "
        f"dense_k={dev.meta.dense_k}, pair={dev.meta.pair_rows > 0}, "
        f"sa_full={dev.meta.has_sa_full}; resident "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, peak {peak / 2**30:.2f} GiB")
    if mem is not None:
        mem.update(peaks=peaks, resident=resident)
    return dev


def run_batch(torch, fm, dev, text, tag: str, pats_np, engine: str, lens=None):
    """One batch through count + locate_with_counts(use_stream=True): every
    check, then queries/s from CUDA events and, of the same windows, the
    synchronised host clock.  ``lens``: per-pattern lengths (None: uniform).
    Returns (counts, location sets, the locate output, seconds after start
    when the first call had answered)."""
    from sview_fmindex_tpu_torch.ops.locate import expand_capacity

    B = pats_np.shape[0]
    patterns = torch.from_numpy(pats_np).to(DEVICE)
    check(dev.engine_for(B, use_stream=True) == engine, f"engine is not {engine}")
    t0 = time.perf_counter()
    counts = dev.count(patterns, lens, use_stream=True)
    capacity = expand_capacity(counts.cpu().numpy())
    out = dev.locate_with_counts(patterns, lens, capacity=capacity, use_stream=True)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    answered_at = time.time() - T_START
    check_batch(torch, fm, dev, text, pats_np, lens, patterns, counts, out)
    reps = max(8, min(32, int(4e6 // B)))
    cw = measure(lambda: dev.count(patterns, lens, use_stream=True), B, reps, clock=None)
    lw = measure(lambda: dev.locate_with_counts(
        patterns, lens, capacity=capacity, use_stream=True), B, reps, clock=None)
    cq, lq = cw["events"], lw["events"]
    shape = (" mixed lengths" if lens is not None else "" if pats_np.shape[1] == PATTERN_LEN
             else f" {pats_np.shape[1]}-symbol patterns")
    log(f"[{tag}] B={B}{shape}: checks OK "
        f"(dropped 0, {N_RECHECK} text re-checks, gather "
        f"parity, {N_ORACLE} host-oracle patterns); first call {warm_s:.3f} s; "
        f"count {max(cq) / 1e6:.3f} Mq/s (worst window {min(cq) / 1e6:.3f}), "
        f"locate {max(lq) / 1e6:.3f} Mq/s (worst window {min(lq) / 1e6:.3f}); "
        f"{int(counts.sum())} hits, capacity {capacity}; host clock, worst-best: count "
        f"{span(min(cw['host']), max(cw['host']))}, locate {span(min(lw['host']), max(lw['host']))}")
    RATES[tag, B] = dict(count=cq, locate=lq)
    locs, pids, valid = out[:3]
    return counts.cpu().numpy(), location_sets(locs, pids, valid, fm.text_len), out, answered_at


def sa_fill_check(torch, fm, dev, tag: str) -> None:
    """The filled SA at every sampled row equals the blob's sampled SA,
    compared a piece of SA_CHECK_PIECE rows at a time (no whole-SA copy)."""
    from sview_fmindex_tpu_torch.ops.rank import u32

    r = fm.sampling_ratio
    m = fm.suffix_array.shape[0]
    check(-(-dev.sa.shape[0] // r) == m, "the filled SA's length")
    for a in range(0, m, SA_CHECK_PIECE):
        want = torch.from_numpy(fm.suffix_array[a:a + SA_CHECK_PIECE].astype(np.int64)).to(DEVICE)
        check(torch.equal(u32(dev.sa[a * r:(a + want.shape[0]) * r:r]), want),
              f"filled SA != the blob's sampled SA at the sampled rows from {a * r}")
    log(f"[{tag}] SA fill check: {m} sampled rows OK")


def sliced_fill_check(torch, fm, dev, ratio: int) -> None:
    """The main index's SA filled again from the same tables, unsliced and
    in slices of GUARD_CHAINS chains: both equal the upload's SA tensor for
    tensor; seconds and device peak above the resident memory of each.  The
    join launches of these fills are not the main path's: the counters are
    put back as they were."""
    from sview_fmindex_tpu_torch.build import sa_fill
    from sview_fmindex_tpu_torch.ops import stream_join as sj

    saved = collections.Counter(sj.LAUNCHES), collections.Counter(sj.LAUNCHES_BY_SIGMA)
    sa_up = torch.from_numpy(fm.suffix_array[::ratio].astype(np.int64)).to(DEVICE)
    R = fm.sampling_ratio * ratio
    old = sa_fill._FILL_CHAINS
    line = []
    try:
        for label, chains in (("unsliced", old), ("sliced", GUARD_CHAINS)):
            sa_fill._FILL_CHAINS = chains
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            sa = sa_fill.fill_sa_full_device(dev.meta, dev.fused, dev.count_arr, dev.sentinel,
                                             sa_up, fm.text_len, R, stream_tbl=dev.stream_tbl)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
            stats = dict(sa_fill.STATS)
            check(torch.equal(sa, dev.sa), f"the {label} fill differs from the upload's SA")
            del sa
            line.append(f"{label}: {stats['slices']} slices of at most {chains} chains, "
                        f"live width {stats['live_width']}, {stats['rounds']} rounds, "
                        f"{secs:.3f} s, peak {peak / 2**30:.3f} GiB above the resident")
        check(stats["slices"] == -(-stats["chains"] // GUARD_CHAINS) > 1
              and stats["live_width"] <= GUARD_CHAINS, "the sliced fill did not slice")
    finally:
        sa_fill._FILL_CHAINS = old
        for counter, was in zip((sj.LAUNCHES, sj.LAUNCHES_BY_SIGMA), saved):
            counter.clear()
            counter.update(was)
    log(f"[main] sliced SA fill check: both equal the upload's SA; {'; '.join(line)}")
    del sa_up
    torch.cuda.empty_cache()


def sa_order_check(torch, dev, text, tag: str, rng) -> None:
    """N_ORDER_PAIRS random adjacent rows (i, i+1) of the filled SA: the
    suffixes at SA[i] and SA[i+1], read from the raw text 32 bytes at a
    time, are in strict order (the end of the text sorts first).  It holds
    the rows the push rounds wrote, which no sampled row covers, to an
    oracle that reads no table."""
    from sview_fmindex_tpu_torch.ops.rank import u32

    n = text.shape[0]
    rows = torch.from_numpy(rng.integers(0, n - 1, N_ORDER_PAIRS)).to(DEVICE)
    first, second = (u32(dev.sa[i]).cpu().numpy() for i in (rows, rows + 1))
    for x, y in zip(first.tolist(), second.tolist()):
        k = 0
        while True:
            u, v = bytes(text[x + k:x + k + 32]), bytes(text[y + k:y + k + 32])
            if u != v or len(u) < 32:
                break
            k += 32
        check(u < v, f"suffixes at SA rows holding {x} and {y} are out of order")
    rows_hi = int((rows >= NARROW_HIGH).sum())
    vals_hi = int((first >= NARROW_HIGH).sum() + (second >= NARROW_HIGH).sum())
    log(f"[{tag}] SA order check: {N_ORDER_PAIRS} adjacent row pairs in strict suffix order "
        f"against the raw text; {rows_hi} of the pairs' rows and {vals_hi} of their "
        f"{2 * N_ORDER_PAIRS} SA values at or above 2^31")
    check(rows_hi > 0 and vals_hi > 0, "the order check reached no row or value of 2^31 or more")


def main_path(torch, ft) -> dict:
    from sview_fmindex_tpu_torch.ops import search
    from sview_fmindex_tpu_torch.ops import stream_join as sj
    text = get_text(TEXT_SIZE)
    t0 = time.perf_counter()
    fm = get_blob(ft, text)
    log(f"[main] text {TEXT_SIZE} bp, blob ready in {time.perf_counter() - t0:.1f} s")

    sj.LAUNCHES.clear()
    sj.LAUNCHES_BY_SIGMA.clear()
    search.LAUNCHES.clear()
    dev = upload(torch, ft, fm, "main", dense_lut_entries=1 << 28,
                 dense_host_entries=1 << 20, sa_full="device", sa_fill_ratio=4)
    upload_launches = dict(sj.LAUNCHES_BY_SIGMA)
    sa_fill_check(torch, fm, dev, "main")
    sliced_fill_check(torch, fm, dev, ratio=4)

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
    by_sigma = dict(sj.LAUNCHES_BY_SIGMA)
    # the gather engine's kernel: the batches' parity gates (use_stream=False)
    gather_launches = search.LAUNCHES["gather"]
    per_call, gather_per_call = {}, {}
    patterns = torch.from_numpy(batches[BATCHES[-1]]["pats"]).to(DEVICE)
    for name, fn in (("count", dev.count), ("locate", dev.locate)):
        before = collections.Counter(sj.LAUNCHES_BY_SIGMA)
        fn(patterns, use_stream=True)
        per_call[name] = dict(collections.Counter(sj.LAUNCHES_BY_SIGMA) - before)
        before = search.LAUNCHES["gather"]
        fn(patterns, use_stream=False)
        gather_per_call[name] = search.LAUNCHES["gather"] - before
    log(f"[main] join launches by (mode, sigma): at upload {upload_launches}; per call at "
        f"B={BATCHES[-1]}: {per_call}")
    log(f"[main] kernel launches on the main path: {launches}; gather search kernel "
        f"{gather_launches}, per gather-engine call at B={BATCHES[-1]}: {gather_per_call}; "
        f"first query {first_query_s:.1f} s after start")
    check(launches.get("rank", 0) > 0, "rank-mode join kernel never launched")
    check(launches.get("decode", 0) > 0, "decode-mode join kernel never launched")
    check(gather_launches > 0, "the gather search kernel never launched on the main path")
    check(all(n > 0 for n in gather_per_call.values()),
          f"a gather-engine call launched no gather search kernel: {gather_per_call}")
    return dict(fm=fm, text=text, dev=dev, by_sigma=by_sigma, batches=batches,
                dense_k=dev.meta.dense_k, gather_per_call=gather_per_call)


def time_join(torch, join_fn, plain_fn, args) -> dict:
    """Kernel and plain times in turns (kernel, plain, plain, kernel), 20
    launches each, CUDA events.  The card first spins for a few
    milliseconds, so the host has every launch queued before the first one
    runs: a wrapper call costs the host about as long as the kernel runs, and
    the events would otherwise time the host."""
    times = {}
    for label, fn in (("ms", join_fn), ("plain_ms", plain_fn),
                      ("plain_ms2", plain_fn), ("ms2", join_fn)):
        fn(*args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HEAD_START_CYCLES)
        start.record()
        for _ in range(20):
            fn(*args)
        end.record()
        end.synchronize()
        times[label] = start.elapsed_time(end) / 20
    return times


def join_bound(torch, table, keys, sym, sigma, decode, seg_base) -> dict:
    """The least time the card could take for one join over these inputs:
    the larger of bytes over the card's memory rate and operations over its
    non-tensor-core rate.  Bytes, each read or written once: the int64 keys,
    the int64 payload (rank modes), of every table row that holds a key its
    plane words and the checkpoint words of the symbols asked there (``sym``:
    the payload, or the decoded symbols), the segment bases asked (segmented
    modes), and the int64 results (rank; the symbol too in decode modes).
    Operations per key: the plane combine, mask, popcount and sum over the
    row's lanes, plus the address arithmetic."""
    from sview_fmindex_tpu_torch.ops import stream_join as sj

    n = keys.shape[0]
    planes = sj._planes_for(sigma)
    rows = (keys >> sj.SBL_SHIFT).clamp(max=table.shape[0] - 1)
    rows_touched = int(torch.unique(rows).numel())
    # three int64 vectors either way: key, payload, rank or key, rank, symbol
    nbytes = (3 * 8 * n + rows_touched * planes * sj.LANES * 4
              + int(torch.unique(rows * 64 + sym).numel()) * 4)
    if seg_base is not None:
        nbytes += int(torch.unique((rows >> sj._seg_shift()) * 64 + sym).numel()) * 8
    ops = n * (sj.LANES * (2 * planes + 3) + 8)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ALU_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=nbytes, bound_ops=ops, rows_touched=rows_touched)


def kernel_case(torch, name, table, keys, payload, sigma, decode, launches: int,
                seg_base=None):
    """One join mode against its plain version: exact equality, then times.
    ``launches``: the mode's count from its path's run."""
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
    bound = join_bound(torch, table, keys, sk if decode else payload, sigma, decode, seg_base)
    ms = min(times["ms"], times["ms2"])
    log(f"[kernel] {name}: sigma={sigma} table {table.shape[0]}x{table.shape[1]}, "
        f"{keys.shape[0]} sorted keys (max {int(keys[-1])}): exact (max_abs_err 0); "
        f"kernel {times['ms']:.4f}/{times['ms2']:.4f} ms, plain "
        f"{times['plain_ms']:.4f}/{times['plain_ms2']:.4f} ms; bound {bound['bound_ms']:.4f} ms "
        f"by {bound['bound_by']} ({bound['bound_bytes']} bytes, {bound['rows_touched']} of "
        f"{table.shape[0]} rows touched, {bound['bound_ops']} operations): "
        f"{bound['bound_ms'] / ms:.2f} of the kernel's time; no single PyTorch call "
        f"computes the join (library_ms null)")
    return dict(name=name, route="cuda", source=JOIN_SRC, replaces=JOIN_TPU,
                launches=launches, max_abs_err=err, ms=ms,
                plain_ms=min(times["plain_ms"], times["plain_ms2"]),
                bound_ms=bound["bound_ms"], bound_by=bound["bound_by"], library_ms=None,
                bound_bytes=bound["bound_bytes"])


def kernel_keys(torch, dev, rng, high_from: tuple = ()):
    """KERNEL_KEYS sorted keys over [0, n] (one B=1M search pass), the
    sentinel row's keys and key n included; for each bound of ``high_from``
    an equal share of them drawn from [bound, n], and the keys on both
    sides of it."""
    n = int(dev.count_arr[-1])
    special = [0, dev.sentinel - 1, dev.sentinel, dev.sentinel + 1, n]
    for h in high_from:
        special += [h - 1, h, h + 1]
    special = torch.tensor(special, device=DEVICE)
    m = KERNEL_KEYS - special.shape[0]
    share = m // (len(high_from) + 1)
    drawn = np.concatenate([rng.integers(0, n + 1, size=m - share * len(high_from))]
                           + [rng.integers(h, n + 1, size=share) for h in high_from])
    return torch.sort(torch.cat([special, torch.from_numpy(drawn).to(DEVICE)]))[0]


def kernel_cases(torch, dev, rng, cases, launches: dict, seg_base=None,
                 high_from: tuple = ()) -> list[dict]:
    """``cases``: (name, table, sigma, decode) on ``dev``'s keys, each with
    its mode's count from ``launches`` (keyed by (mode, sigma)).
    ``high_from``: see :func:`kernel_keys`."""
    keys = kernel_keys(torch, dev, rng, high_from)
    out = []
    for name, table, sigma, decode in cases:
        payload = None if decode else torch.from_numpy(
            rng.integers(0, sigma, size=KERNEL_KEYS)).to(DEVICE)
        mode = ("decode" if decode else "rank") + ("" if seg_base is None else "_seg")
        out.append(kernel_case(torch, name, table, keys, payload, sigma, decode,
                               launches.get((mode, sigma), 0), seg_base))
    return out


def kernel_phase(torch, dev, by_sigma: dict) -> list[dict]:
    rng = np.random.default_rng(SEED + 2)
    # join_rank_sigma4: the rank mode on the sigma=4 stream table, the launch
    # of the micro suite's ``rank`` group; its count is filled in from that run
    cases = [("join_rank", dev.pair_tbl, 16, False), ("join_decode", dev.stream_tbl, 4, True),
             ("join_rank_sigma4", dev.stream_tbl, 4, False)]
    return kernel_cases(torch, dev, rng, cases, by_sigma)


def gather_search_phase(torch, dev, text, per_call: dict) -> list[dict]:
    """The gather engine's kernel (``ops/search.gather_ranges_cuda``)
    against its plain version, the per-step loop on the card
    (``ops/search.gather_ranges``), on the main path's index: GATHER_BATCHES
    20-bp windows of the text, exactly equal, then times in turns.  Launches
    a call: the kernel's as the main path's gather-engine locate calls
    launched it (``per_call``, read from ``ops/search.LAUNCHES``), and the
    plain version's device kernels and copies in one profiled call.  Bound: the bytes the search needs (each
    pattern's int64 symbols and length, its two dense seed words, one fused
    row per LF step and range end, the two int64 ends out) over the card's
    memory rate; the search is a chain of dependent row reads per end, so
    latency, not that rate, bounds it at these batches."""
    from torch.profiler import ProfilerActivity, profile

    from sview_fmindex_tpu_torch.models.device_index import _as_batch
    from sview_fmindex_tpu_torch.ops import search

    rng = np.random.default_rng(SEED + 23)
    out = []
    for B in GATHER_BATCHES:
        starts = rng.integers(0, TEXT_SIZE - PATTERN_LEN, size=B)
        pats = np.ascontiguousarray(text[starts[:, None] + np.arange(PATTERN_LEN)])
        p, lens, steps, (all_dense, fixed_len) = _as_batch(dev.meta, pats, None, dev.device)
        sym = search.encode_patterns(dev.enc_table, p)

        def kernel():
            return search.gather_ranges_cuda(dev, sym, lens, steps)

        def plain():
            return search.gather_ranges(dev, sym, lens, steps, all_dense, fixed_len)

        (klo, khi), (plo, phi) = kernel(), plain()
        torch.cuda.synchronize()
        err = max(int((klo - plo).abs().max()), int((khi - phi).abs().max()))
        check(err == 0, f"gather_search B={B} differs from its plain version by {err}")
        check(bool((khi > klo).all()), f"gather_search B={B}: a window of the text not found")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            plain()
            torch.cuda.synchronize()
        plain_launches = sum(e.device_type == torch.autograd.DeviceType.CUDA
                             for e in prof.events())
        times = time_join(torch, kernel, plain, ())
        row_bytes = dev.fused.shape[1] * 4
        nbytes = B * (PATTERN_LEN * 8 + 8 + 2 * 4 + 2 * steps * row_bytes + 2 * 8)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ms = min(times["ms"], times["ms2"])
        log(f"[kernel] gather_search B={B}: {steps} LF steps after dense_k "
            f"{dev.meta.dense_k}, fused rows of {row_bytes} B: exact (max_abs_err 0); kernel "
            f"{times['ms']:.4f}/{times['ms2']:.4f} ms in {per_call['locate']} launch(es) a "
            f"main-path locate call, plain "
            f"{times['plain_ms']:.4f}/{times['plain_ms2']:.4f} ms in {plain_launches} device "
            f"kernels and copies; bound {bound_ms:.4f} ms by bytes ({nbytes} B), "
            f"{bound_ms / ms:.3f} of the kernel's time: latency-bound (a chain of {steps} "
            f"dependent row reads per end)")
        out.append(dict(name=f"gather_search_b{B}", route="cuda", source=GATHER_SRC,
                        replaces=GATHER_TPU, launches=per_call["locate"],
                        plain_launches=plain_launches,
                        max_abs_err=err, ms=ms,
                        plain_ms=min(times["plain_ms"], times["plain_ms2"]),
                        bound_ms=bound_ms, bound_by="bytes (latency-bound)", library_ms=None,
                        bound_bytes=nbytes))
    return out


def wide_checks(torch, ft, fm, text, tag: str, batches: dict, dense_k: int = 10,
                kernel_cases_of=None, on_index=None, **upload_kw) -> tuple[dict, list[dict]]:
    """Upload ``fm`` as a wide index and put every batch through run_batch
    on the wide stream engine; where ``batches`` carries the narrow path's
    answers, the wide ones must equal them.  ``kernel_cases_of(dev)``: the
    segmented kernel cases to run on the wide tables; ``on_index(dev)``: a
    last check of the index before it is freed.  Returns the launch counts
    per mode and those cases' kernel summary entries."""
    from sview_fmindex_tpu_torch.ops import stream_join as sj

    sj.LAUNCHES.clear()
    sj.LAUNCHES_BY_SIGMA.clear()
    dev = upload(torch, ft, fm, tag, dense_lut_entries=1 << 28,
                 dense_host_entries=1 << 20, **upload_kw)
    check(dev.meta.wide_pos and dev.meta.dense_k == dense_k and not dev.meta.has_sa_full,
          f"not a wide index with host dense seeds (dk {dense_k}) and a sampled SA")
    for B, want in batches.items():
        counts, sets, out, _ = run_batch(torch, fm, dev, text, tag, want["pats"], "wide-stream",
                                         want.get("lens"))
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
    by_sigma = dict(sj.LAUNCHES_BY_SIGMA)
    log(f"[{tag}] kernel launches: {launches}; by (mode, sigma): {by_sigma}")
    sigma = dev.meta.sigma
    check(by_sigma.get(("rank_seg", sigma), 0) > 0, "segmented rank mode never launched")
    check(by_sigma.get(("decode_seg", sigma), 0) > 0, "segmented decode mode never launched")
    check(not launches.get("rank") and not launches.get("decode"),
          "a wide index launched a narrow join mode")
    kernels = [] if kernel_cases_of is None else kernel_cases(
        torch, dev, np.random.default_rng(SEED + 7), kernel_cases_of(dev), by_sigma,
        dev.seg_base)
    if on_index is not None:
        on_index(dev)
    del dev
    torch.cuda.empty_cache()
    return launches, kernels


def walk_phase(torch, ft, fm, text, main: dict) -> list[dict]:
    from sview_fmindex_tpu_torch.ops import locate
    from sview_fmindex_tpu_torch.ops import stream_join as sj

    sj.LAUNCHES.clear()
    locate.LAUNCHES.clear()
    dev = upload(torch, ft, fm, "walk", dense_lut_entries=1 << 28, dense_host_entries=1 << 20)
    check(not dev.meta.has_sa_full, "the walk phase needs the sampled SA")
    want = main["batches"][WALK_BATCH]
    counts, sets, _, _ = run_batch(torch, fm, dev, text, "walk", want["pats"], "pair-stream")
    check(np.array_equal(counts, want["counts"]), "walk counts != main path counts")
    check(np.array_equal(sets, want["sets"]), "walk location sets != main path ones")
    log(f"[walk] B={WALK_BATCH}: counts and location sets equal the main path's; "
        f"walk kernel launches {dict(locate.LAUNCHES)}, join launches {dict(sj.LAUNCHES)}")
    check(locate.LAUNCHES["walk"] > 0, "the walk never launched its kernel")
    check(not sj.LAUNCHES.get("decode"), "the walk launched the join's decode mode")
    out = walk_kernel_case(torch, dev, main["batches"][BATCHES[-1]]["pats"])
    del dev
    torch.cuda.empty_cache()
    return out


def walk_kernel_case(torch, dev, pats_np) -> list[dict]:
    """The LF walk's kernel (``ops/locate.walk_rows_cuda``) against its
    plain version as the walk ran before it, ``ops/locate.lf_walk`` decoding
    through the join's decode mode, on an r = WALK_RATIO index of the main
    text (``dev``'s sampled SA taken every WALK_RATIO / r-th entry): the
    expand buffer of ``pats_np`` (B=1M 20-bp windows), exactly equal on
    every lane, times in turns, and the walk's counts from one traced call
    of each, which must agree.  The launches a call are read from one
    ``locate`` of the same batch through the r = WALK_RATIO index, the
    main path's walk, and must be 1.  Bound: the bytes the kernel reads
    and writes over the card's memory rate: one fused row (``row_words``
    words, one 32-B sector at dna20) a row step, the row, its valid byte
    and its answer (17 B) a lane of the buffer, and a sampled SA word a
    located row.  ``fmbench/metrics/walk_roofline.locate.py`` counts a
    layout-free 36 B a row step instead."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from sview_fmindex_tpu_torch import tracing
    from sview_fmindex_tpu_torch.ops import locate
    from sview_fmindex_tpu_torch.ops import stream_join as sj

    r0 = dev.meta.sampling_ratio
    check(WALK_RATIO % r0 == 0, f"the walk upload's ratio {r0} does not divide {WALK_RATIO}")
    sa32 = dataclasses.replace(dev, sa=dev.sa[::WALK_RATIO // r0].contiguous(),
                               meta=dataclasses.replace(dev.meta, sampling_ratio=WALK_RATIO))
    patterns = torch.from_numpy(pats_np).to(DEVICE)
    B = patterns.shape[0]
    lo, hi = sa32.pos_ranges(patterns, use_stream=True)
    capacity, rows_located = locate.device_capacity(hi - lo)
    rows, _, valid, _ = locate.expand_ranges(lo, hi, capacity)
    args = (sa32.meta, sa32.fused, sa32.count_arr, sa32.sa, sa32.sentinel, rows, valid)

    def kernel():
        return locate.walk_rows_cuda(*args)

    def decode(pos):
        return sj.pre_rank_and_symidx_sorted(sa32.stream_tbl, sa32.sentinel, pos,
                                             sa32.meta.sigma)

    def plain():
        return locate.lf_walk(WALK_RATIO, sa32.count_arr, sa32.sa, rows, valid, decode)

    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = int((got - ref).abs().max())
    check(err == 0, f"lf_walk B={B} differs from its plain version by {err}")
    counted = []
    for fn in (kernel, plain):
        tracing.COUNTS.clear()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counted.append({k: tracing.COUNTS[k] for k in ("walk_steps", "walk_row_steps",
                                                       "walk_lanes", "syncs")})
    plain_launches = sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())
    kc, pc = counted
    check(kc["walk_steps"] == pc["walk_steps"] and kc["walk_row_steps"] == pc["walk_row_steps"],
          f"the kernel's walk counts {kc} differ from the plain walk's {pc}")
    check(kc["walk_lanes"] == kc["walk_row_steps"] and kc["syncs"] == 1,
          f"the kernel's lanes or syncs are off: {kc}")
    locate.LAUNCHES.clear()
    sa32.locate(patterns, use_stream=True)
    per_call = locate.LAUNCHES["walk"]
    check(per_call == 1, f"a locate call through the r={WALK_RATIO} index launched the walk "
          f"kernel {per_call} times, not once")
    times = time_join(torch, kernel, plain, ())
    nbytes = 4 * sa32.fused.shape[1] * kc["walk_row_steps"] + 17 * capacity + 4 * rows_located
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ms = min(times["ms"], times["ms2"])
    plain_ms = min(times["plain_ms"], times["plain_ms2"])
    log(f"[kernel] lf_walk r={WALK_RATIO} B={B}: {rows_located} rows located, capacity "
        f"{capacity}, {kc['walk_row_steps']} row steps, the longest {kc['walk_steps']}: exact "
        f"(max_abs_err 0); kernel {times['ms']:.4f}/{times['ms2']:.4f} ms, {per_call} "
        f"launch a locate call, plain (join decode) {times['plain_ms']:.4f}/"
        f"{times['plain_ms2']:.4f} ms in {plain_launches} device kernels and copies, "
        f"{pc['syncs']} syncs; bound {bound_ms:.4f} ms by bytes ({nbytes} B), "
        f"{bound_ms / ms:.3f} of the kernel's time; x{plain_ms / ms:.1f} on the plain walk")
    return [dict(name=f"lf_walk_r{WALK_RATIO}_b{B}", route="cuda", source=WALK_SRC,
                 replaces=WALK_TPU, launches=per_call, plain_launches=plain_launches,
                 max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                 bound_by="bytes (latency-bound)", library_ms=None, bound_bytes=nbytes)]


def segmented_kernel_phase(torch, launches: dict) -> list[dict]:
    from sview_fmindex_tpu_torch.ops import stream_join as sj

    sigma = 4
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    table = synthetic_table(torch, g, SEG_ROWS, sigma)
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
                       launches.get("rank_seg", 0), seg_base),
           kernel_case(torch, "join_decode_seg", table, keys, None, sigma, True,
                       launches.get("decode_seg", 0), seg_base)]
    del table
    torch.cuda.empty_cache()
    return out


def synthetic_table(torch, g, rows: int, sigma: int, ckpt: tuple = (0, 2**31)):
    """A seeded random table of ``rows`` rows: every bit pattern in the
    planes, checkpoint values drawn from [ckpt[0], ckpt[1]) (below 2^31 by
    default: what a local count can be) and stored as their 32-bit words."""
    from sview_fmindex_tpu_torch.ops import stream_join as sj
    from sview_fmindex_tpu_torch.ops.rank import to_i32

    table = torch.randint(-2**31, 2**31, (rows, sj._rw(sigma)), generator=g,
                          device=DEVICE).to(torch.int32)
    table[:, :sigma] = to_i32(torch.randint(*ckpt, (rows, sigma), generator=g, device=DEVICE))
    return table


def hbm_kernel_phase(torch, by_sigma: dict) -> list[dict]:
    """The main path's two modes on tables of the 1 Gbp deployment's size."""
    return synthetic_kernel_phase(
        torch, SEED + 11, HBM_ROWS, (("join_rank_hbm", 16, False), ("join_decode_hbm", 4, True)),
        by_sigma)


def hi_ckpt_phase(torch, by_sigma: dict) -> list[dict]:
    """The main path's two modes on narrow tables whose checkpoint words all
    lie in HI_CKPT, 2^31 and above, as every table of an index between 2^31
    and 2^32 bp holds past its middle: words that read negative as int32;
    then on tables whose words lie in TOP_CKPT, the top of the u32 range."""
    return synthetic_kernel_phase(
        torch, SEED + 16, HI_CKPT_ROWS,
        (("join_rank_hi_ckpt", 16, False), ("join_decode_hi_ckpt", 4, True)), by_sigma,
        HI_CKPT) + synthetic_kernel_phase(
        torch, SEED + 18, HI_CKPT_ROWS,
        (("join_rank_top_ckpt", 16, False), ("join_decode_top_ckpt", 4, True)), by_sigma,
        TOP_CKPT)


def synthetic_kernel_phase(torch, seed: int, rows: int, cases, by_sigma: dict,
                           ckpt: tuple = (0, 2**31)) -> list[dict]:
    """``cases``: (name, sigma, decode), each on a seeded synthetic table of
    ``rows`` rows (checkpoints from ``ckpt``) at 2M sorted keys against its
    plain version.  ``by_sigma``: the main path's launches, whose count of
    the same mode and sigma is the kernel these cases time."""
    from sview_fmindex_tpu_torch.ops import stream_join as sj
    from sview_fmindex_tpu_torch.ops.rank import u32

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    out = []
    for name, sigma, decode in cases:
        table = synthetic_table(torch, g, rows, sigma, ckpt)
        words = u32(table[:, :sigma])
        check(bool(((words >= ckpt[0]) & (words < ckpt[1])).all()),
              f"{name}: checkpoint words outside {ckpt}")
        del words
        end = rows * sj.SBL
        special = torch.tensor([0, end - 1, end], device=DEVICE)
        keys = torch.sort(torch.cat([special, torch.randint(
            0, end + 1, (KERNEL_KEYS - special.shape[0],), generator=g, device=DEVICE)]))[0]
        payload = None if decode else torch.randint(0, sigma, (KERNEL_KEYS,), generator=g,
                                                    device=DEVICE)
        log(f"[kernel] {name}: table {table.numel() * 4 / 2**30:.2f} GiB, checkpoint words "
            f"in [{ckpt[0]}, {ckpt[1]})")
        out.append(kernel_case(torch, name, table, keys, payload, sigma, decode,
                               by_sigma.get(("decode" if decode else "rank", sigma), 0)))
        del table
        torch.cuda.empty_cache()
    return out


def ragged_phase(torch) -> None:
    """Every ragged-edge key set through kernel and plain version on the
    card: all four modes at sigma 4, 16 (rows staged whole) and 20 (planes
    only), 8-row segments; exactly equal."""
    from sview_fmindex_tpu_torch.bench.join_cases import RAGGED_CASES, ragged_keys
    from sview_fmindex_tpu_torch.ops import stream_join as sj

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    old, n = sj.SEG_BLOCKS, 0
    sj.SEG_BLOCKS = RAGGED_SEG_ROWS
    try:
        for sigma in (4, 16, 20):
            table = synthetic_table(torch, g, RAGGED_ROWS, sigma)
            seg_base = torch.randint(0, 2**35, (RAGGED_ROWS // RAGGED_SEG_ROWS, sigma),
                                     generator=g, device=DEVICE)
            for case in RAGGED_CASES:
                keys = torch.from_numpy(ragged_keys(case, RAGGED_ROWS, RAGGED_SEG_ROWS,
                                                    seed=sigma)).to(DEVICE)
                payload = torch.randint(0, 64, keys.shape, generator=g, device=DEVICE)
                for decode in (False, True):
                    for base in (None, seg_base):
                        pay = None if decode else payload
                        got = sj.join(table, keys, pay, sigma, decode, base)
                        want = sj.join_plain(table, keys, pay, sigma, decode, base)
                        torch.cuda.synchronize()
                        check(all(a is None or torch.equal(a, b) for a, b in zip(got, want)),
                              f"ragged case {case} differs at sigma={sigma}, decode={decode}, "
                              f"segmented={base is not None}")
                        n += 1
    finally:
        sj.SEG_BLOCKS = old
    log(f"[kernel] ragged edges: {n} runs ({len(RAGGED_CASES)} key sets x 3 sigmas x 4 modes) "
        f"equal their plain version exactly")


def unfilled_scan_phase(torch) -> None:
    """The SA fill's unfilled-row scan (``build/sa_fill.unfilled_rows``) over
    a seeded int32 tensor of SCAN_ENTRIES words, more than INT_MAX: random
    words, a third of them with the high bit set, none -1 but the
    SCAN_PLANTED planted ones (the first and last rows and both sides of
    2^31 among them); it must return exactly the planted rows."""
    from sview_fmindex_tpu_torch.build.sa_fill import unfilled_rows

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 17)
    words = torch.empty(SCAN_ENTRIES, dtype=torch.int32, device=DEVICE)
    piece = 1 << 28
    for a in range(0, SCAN_ENTRIES, piece):
        w = words[a:a + piece]
        w.random_(0, 2**31 - 1, generator=g)  # [0, 2^31 - 2]
        w[::3] ^= -2**31  # [-2^31, -2]: the high bit set, never -1
    rng = np.random.default_rng(SEED + 17)
    special = np.array([0, NARROW_HIGH - 1, NARROW_HIGH, SCAN_ENTRIES - 1])
    rest = np.setdiff1d(np.unique(rng.integers(0, SCAN_ENTRIES, 2 * SCAN_PLANTED)), special)
    planted = np.sort(np.concatenate([special, rng.permutation(rest)[:SCAN_PLANTED - 4]]))
    words[torch.from_numpy(planted).to(DEVICE)] = -1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = unfilled_rows(words)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(np.array_equal(rows.cpu().numpy(), planted),
          f"the unfilled-row scan found {rows.shape[0]} rows, not the {planted.size} planted")
    log(f"[kernel] unfilled-row scan over {SCAN_ENTRIES} int32 words "
        f"({SCAN_ENTRIES * 4 / 2**30:.2f} GiB): exactly the {planted.size} planted rows "
        f"({int((planted >= NARROW_HIGH).sum())} of them at or above 2^31) in {secs:.3f} s")
    del words, rows
    torch.cuda.empty_cache()


def narrow_phase(torch, ft, tag: str, text, alphabet: str, batches: list, engine: str,
                 kernel_cases_of) -> tuple:
    """Phases A and B: the blob of ``alphabet`` over ``text``, the main
    path's upload, every batch (a dict of ``pats`` and maybe ``lens``)
    through run_batch, its answers stored in the dict, both narrow join
    modes launched at the alphabet's sigma,
    then ``kernel_cases_of(dev)`` against their plain version.  Returns
    (fm, launches by (mode, sigma), kernel summary entries)."""
    from sview_fmindex_tpu_torch.ops import stream_join as sj

    t0 = time.perf_counter()
    fm = get_blob(ft, text, alphabet=alphabet)
    sigma = fm.symbol_count
    log(f"[{tag}] text {text.shape[0]} symbols, sigma={sigma}, blob ready in "
        f"{time.perf_counter() - t0:.1f} s")
    sj.LAUNCHES.clear()
    sj.LAUNCHES_BY_SIGMA.clear()
    dev = upload(torch, ft, fm, tag, dense_lut_entries=1 << 28,
                 dense_host_entries=1 << 20, sa_full="device", sa_fill_ratio=4)
    check(dev.meta.stream_rows > 0 and (dev.meta.pair_rows > 0) == (sigma * sigma <= 63),
          f"sigma={sigma} uploaded without its join tables")
    sa_fill_check(torch, fm, dev, tag)
    for want in batches:
        counts, sets, _, _ = run_batch(torch, fm, dev, text, tag, want["pats"], engine,
                                       want.get("lens"))
        want.update(counts=counts, sets=sets)
    by_sigma = dict(sj.LAUNCHES_BY_SIGMA)
    log(f"[{tag}] kernel launches: {dict(sj.LAUNCHES)}; by (mode, sigma): {by_sigma}")
    check(by_sigma.get(("rank", sigma), 0) > 0, f"rank mode never launched at sigma={sigma}")
    check(by_sigma.get(("decode", sigma), 0) > 0, f"decode mode never launched at sigma={sigma}")
    kernels = kernel_cases(torch, dev, np.random.default_rng(SEED + 6), kernel_cases_of(dev),
                           by_sigma)
    del dev
    torch.cuda.empty_cache()
    return fm, by_sigma, kernels


def protein_phase(torch, ft) -> list[dict]:
    """A: BASELINE config 4 at TEXT_SIZE residues, mixed 10-30 aa batches on
    the stream engine (the per-step path), then the same blob wide."""
    text = get_protein_text(TEXT_SIZE)
    rng = np.random.default_rng(SEED + 5)
    lo, hi = PROT_LENS
    batches = []
    for B in BATCHES:
        lens = rng.integers(lo, hi + 1, size=B)
        starts = rng.integers(0, TEXT_SIZE - hi, size=B)
        pats = np.ascontiguousarray(text[starts[:, None] + np.arange(hi)])
        pats[np.arange(hi)[None, :] >= lens[:, None]] = 0  # past each length: ignored
        batches.append(dict(pats=pats, lens=lens))
    fm, _, kernels = narrow_phase(
        torch, ft, "prot", text, "prot", batches, "stream",
        lambda dev: [("join_rank_sigma20", dev.stream_tbl, 20, False),
                     ("join_decode_sigma20", dev.stream_tbl, 20, True)])
    _, wide_kernels = wide_checks(
        torch, ft, fm, text, "prot_wide", {WALK_BATCH: batches[0]}, dense_k=4,
        kernel_cases_of=lambda dev: [("join_rank_seg_sigma20", dev.stream_tbl, 20, False),
                                     ("join_decode_seg_sigma20", dev.stream_tbl, 20, True)],
        force_wide=True)
    return kernels + wide_kernels


def wild_patterns(text: np.ndarray, edges: np.ndarray, rng, B: int, plen: int) -> np.ndarray:
    """B windows of the wildcard text: none wholly inside an N run (those
    match about a million places each), and 1% straddling a run's edge (a
    position of ``edges`` and the next), so they hold the wildcard and have
    few hits."""
    size, N = text.shape[0], ord("N")

    def windows(starts):
        return np.ascontiguousarray(text[starts[:, None] + np.arange(plen)])

    pats = windows(rng.integers(0, size - plen, size=B))
    while True:
        inside = np.flatnonzero((pats == N).all(1))
        if not inside.size:
            break
        pats[inside] = windows(rng.integers(0, size - plen, size=inside.size))
    edges = edges[(edges >= plen) & (edges < size - plen)]
    at = rng.choice(edges, size=B // 100)
    pats[rng.choice(B, size=B // 100, replace=False)] = windows(
        at + 1 - rng.integers(1, plen, size=at.size))
    return pats


def wildcard_phase(torch, ft) -> list[dict]:
    """B: the main path's text with N runs over 1% of it, five symbols (N
    and every other byte the wildcard): the 20-bp batches take the sorted
    pair chain over the 25-code pair table, the 21-bp one adds the odd
    pass over the sigma=5 table; then the same blob wide."""
    text = get_wild_text(TEXT_SIZE)
    rng = np.random.default_rng(SEED + 8)
    edges = np.flatnonzero(np.diff((text == ord("N")).view(np.int8)))  # N runs' edges
    batches = [dict(pats=wild_patterns(text, edges, rng, B, plen))
               for B, plen in ((BATCHES[0], WILD_LENS[0]), (BATCHES[1], WILD_LENS[0]),
                               (WALK_BATCH, WILD_LENS[1]))]
    n_wild = sum(int((w["pats"] == ord("N")).any(1).sum()) for w in batches)
    log(f"[wild] {n_wild} patterns hold the wildcard")
    check(n_wild > 0, "no pattern holds the wildcard")
    fm, by_sigma, kernels = narrow_phase(
        torch, ft, "wild", text, "wild", batches, "pair-stream",
        lambda dev: [("join_rank_sigma5", dev.stream_tbl, 5, False),
                     ("join_decode_sigma5", dev.stream_tbl, 5, True),
                     ("join_rank_pair25", dev.pair_tbl, 25, False)])
    check(by_sigma.get(("rank", 25), 0) > 0, "the 25-code pair table was never ranked")
    wide_checks(torch, ft, fm, text, "wild_wide", {WALK_BATCH: batches[0]},
                dense_k=8, force_wide=True)
    return kernels


REPO_DIR = os.path.dirname(os.path.abspath(__file__))


def run_surface(tag: str, cmd: list, env: dict | None = None,
                deadline: int = SURFACE_DEADLINE) -> str:
    """Run one bench surface as a subprocess (its stderr passes through) and
    return its stdout; a non-zero exit or a run past ``deadline`` seconds
    fails."""
    env = dict(os.environ, BENCH_CACHE_DIR=CACHE_DIR,
               PYTHONPATH=REPO_DIR + os.pathsep + os.environ.get("PYTHONPATH", ""), **(env or {}))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, *cmd], env=env, cwd=REPO_DIR,
                              stdout=subprocess.PIPE, text=True, timeout=deadline)
    except subprocess.TimeoutExpired:  # run() has killed the child
        raise RuntimeError(f"{tag}: still running after {deadline} s")
    check(proc.returncode == 0, f"{tag}: exit code {proc.returncode}\n{proc.stdout[-2000:]}")
    log(f"[{tag}] exit 0 in {time.perf_counter() - t0:.1f} s")
    return proc.stdout


def last_json(tag: str, out: str) -> dict:
    lines = out.strip().splitlines()
    check(lines, f"{tag}: no output")
    try:
        return json.loads(lines[-1])
    except ValueError:
        raise RuntimeError(f"{tag}: the last line is not JSON: {lines[-1][:300]}")


def span(lo: float, hi: float) -> str:
    return f"{lo / 1e6:.3f}-{hi / 1e6:.3f}"


def bad_symbol_step(torch, ft) -> None:
    """Step 0: an out-of-alphabet symbol on a PassThrough index raises on the
    host, and the CUDA context goes on answering."""
    rng = np.random.default_rng(SEED + 13)
    sigma = 6
    text = rng.integers(0, sigma, 2500, dtype=np.uint8).tobytes()
    builder = ft.FmIndexBuilder(
        len(text), sigma, ft.PassThrough(), position="u32", block=ft.BLOCK3_U64,
        suffix_array_config=ft.SuffixArrayConfig.compressed(2),
        lookup_table_config=ft.LookupTableConfig.kmer_size(2))
    fm = ft.FmIndex.load(builder.build(text), position="u32", block=ft.BLOCK3_U64,
                         encoder_kind="pass")
    good = np.frombuffer(text[100:108], np.uint8)[None, :].copy()
    for kw in (dict(dense_lut_entries=0), dict(dense_lut_entries=0, force_wide=True)):
        dev = ft.to_device_torch(fm, **kw)
        for bad in ([6, 1], [255], [1, 200, 3], [7, 0, 1, 2, 3]):
            for batch in (np.array([bad], np.uint8), torch.tensor([bad], dtype=torch.uint8,
                                                                  device=DEVICE)):
                for us in (True, False):
                    try:
                        dev.count(batch, use_stream=us)
                    except ValueError as exc:
                        check(f"symbol {max(bad)}" in str(exc), f"the error names no symbol: {exc}")
                    else:
                        raise RuntimeError(f"pattern {bad} raised nothing on a sigma-6 index")
        counts = dev.count(good, use_stream=True)
        torch.cuda.synchronize()
        check(int(counts[0]) == fm.count(good[0].tobytes()) >= 1,
              "the query after the refused batch is wrong")
    log("[surfaces] out-of-alphabet symbols on a sigma-6 PassThrough index (narrow and wide, "
        "both engines, host and device batches): ValueError each time, and the next query "
        "on the same CUDA context answers")


def bench_torch_step() -> dict:
    out = run_surface("bench_torch", ["bench_torch.py"], dict(BENCH_TEXT_SIZE=str(TEXT_SIZE)))
    res = last_json("bench_torch", out)
    keys = {"metric", "value", "value_worst", "unit", "vs_baseline", "count_qps",
            "count_qps_worst", "headline_batch", "text_size", "batches", "build_s",
            "upload_s", "upload_phases", "first_query_s", "launches", "device"}
    check(keys <= set(res), f"bench_torch: keys missing: {sorted(keys - set(res))}")
    check(res["value"] > 0 and res["text_size"] == TEXT_SIZE, "bench_torch: value or text size")
    check(set(res["batches"]) == {str(b) for b in BATCHES}, "bench_torch: a batch is missing")
    check(res["device"]["platform"] == "gpu" and res["device"]["smi"], "bench_torch: no card named")
    log(f"[bench_torch] {res['device']['smi']}; upload {res['upload_s']} s "
        f"{res['upload_phases']}; first query {res['first_query_s']} s after its start")
    launches = res["launches"]
    log(f"[bench_torch] join launches of its own run, by mode@sigma: {launches}")
    check(launches["upload"].get("decode@4", 0) > 0, "bench_torch: the SA fill never launched "
          "the decode mode")
    for B in BATCHES:
        for call in ("count", "locate"):
            check(launches[str(B)][call].get("rank@16", 0) > 0,
                  f"bench_torch: one {call} call at B={B} launched no rank mode at sigma 16")
    for B in BATCHES:
        r, main = res["batches"][str(B)], RATES["main", B]
        for k in ("count_qps", "count_qps_worst", "locate_qps", "locate_qps_worst",
                  "count_qps_events", "locate_qps_events", "hits", "capacity"):
            check(r.get(k, 0) > 0, f"bench_torch: B={B} {k} = {r.get(k)}")
        log(f"[bench_torch] B={B}: count {span(r['count_qps_worst'], r['count_qps'])} Mq/s on the "
            f"host clock, {span(r['count_qps_events_worst'], r['count_qps_events'])} from CUDA "
            f"events (phase 3, events: {span(min(main['count']), max(main['count']))}); locate "
            f"{span(r['locate_qps_worst'], r['locate_qps'])} host, "
            f"{span(r['locate_qps_events_worst'], r['locate_qps_events'])} events (phase 3: "
            f"{span(min(main['locate']), max(main['locate']))}); worst-best of 5 windows")
    return res


def micro_step(torch, dense_k: int) -> dict:
    from sview_fmindex_tpu_torch.bench import micro

    groups = "rank,sort,search,locate,build"
    rep = micro.main(["--text-size", str(TEXT_SIZE), "--cache-dir", CACHE_DIR,
                      "--batches", MICRO_BATCHES, "--groups", groups,
                      "--out", os.path.join(CACHE_DIR, "micro_smoke.json")])
    torch.cuda.empty_cache()
    n_b = len(MICRO_BATCHES.split(","))
    by_group = collections.Counter(r["group"] for r in rep["rows"])
    check(by_group["rank"] == 3 * n_b and by_group["sort"] == 2 * n_b
          and by_group["search"] == 2 * n_b and by_group["locate"] == 5 * n_b
          and by_group["build"] >= 2, f"micro: rows per group {dict(by_group)}")
    check(all(np.isfinite(r["value"]) and r["value"] >= 0 for r in rep["rows"]),
          "micro: a row's value is not finite")
    check(rep["launches"]["rank"] > 0 and rep["launches"]["search"] > 0,
          f"micro: the rank mode never launched: {rep['launches']}")
    check(rep["dense_k"] == dense_k,
          f"micro: dense_k {rep['dense_k']} is not the main path's {dense_k}")
    log(f"[micro] {len(rep['rows'])} rows, dense_k={rep['dense_k']}; join launches per group "
        f"{rep['launches']}; search rows, gather against stream:")
    for line in micro.crossover_table(rep["rows"]):
        log(f"[micro] {line}")
    for r in rep["rows"]:
        if r["group"] in ("rank", "sort") or r["name"].startswith("upload["):
            log(f"[micro] {r['group']} {r['name']} B={r['B']}: {r['value']} {r['unit']}")
    return rep


def cli_step() -> None:
    from sview_fmindex_tpu_torch.bench import cli
    from sview_fmindex_tpu_torch.ops import stream_join as sj

    data = tempfile.mkdtemp(prefix="sview_cli_")

    def run(*argv) -> str:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main([*argv])
        return buf.getvalue()

    try:
        run("generate-text", "-d", data, "-t", str(CLI_TEXT), "-s", str(SEED))
        run("generate-pattern", "-d", data, "-n", str(CLI_PATTERNS), "-c", str(CLI_COLD),
            "-s", str(SEED + 1))
        run("build", "-d", data, "-a", "memory")
        results = os.path.join(data, "sview-memory-block3-results.txt")
        outs = {}
        for algo, extra in (("memory", ()), ("device", ("--serve", "8"))):
            before = collections.Counter(sj.LAUNCHES_BY_SIGMA)
            out = run("locate", "-d", data, "-a", algo, *extra)
            for want in (r"Blob loading time: \d+ ns", r"Locate time: \d+ ns",
                         r"Total time: \d+ ns", r"Index Load \(%\): \d+"):
                check(re.search(f"^{want}$", out, re.M), f"cli locate -a {algo}: no '{want}' line")
            with open(results, "rb") as f:
                outs[algo] = f.read()
            launched = dict(collections.Counter(sj.LAUNCHES_BY_SIGMA) - before)
            log(f"[cli] locate -a {algo}: " + "; ".join(
                ln for ln in out.splitlines() if ln.startswith(("Serve", "Total", "Index")))
                + f"; join launches {launched}")
        check(outs["memory"] == outs["device"] and outs["memory"].count(b"\n") == CLI_PATTERNS,
              "cli: the memory and device result files differ")
        log(f"[cli] {CLI_TEXT} bp, {CLI_PATTERNS} patterns, cold {CLI_COLD}: result files of "
            f"memory and device byte-identical ({len(outs['memory'])} bytes)")
    finally:
        shutil.rmtree(data, ignore_errors=True)


def sweep_step() -> None:
    csv = os.path.join(CACHE_DIR, f"sweep_smoke_{os.getpid()}.csv")
    cells = os.path.join(CACHE_DIR, f"sweep_smoke_{os.getpid()}.json")
    try:
        run_surface("sweep", ["run_benchmark_torch.py", "--algorithms", "mmap,device",
                              "--patterns", "1000", "--colds", "0.1", "--text-size",
                              str(TEXT_SIZE), "--out", csv, "--phases-out", cells])
        with open(csv) as f:
            lines = f.read().strip().splitlines()
        check(lines[0] == "pattern_count,cold_ratio,algorithm,total_ns,load_percent,max_rss_kb"
              and [ln.split(",")[2] for ln in lines[1:]] == ["mmap", "device"],
              f"sweep: CSV {lines}")
        with open(cells) as f:
            for cell in json.load(f):
                ph = {k[:-3]: round(v / 1e9, 3) for k, v in cell["phases"].items()}
                log(f"[sweep] {cell['algorithm']}: total {cell['total_ns'] / 1e9:.3f} s, load "
                    f"{100 * cell['load_ns'] // cell['total_ns']}%, query "
                    f"{cell['query_ns'] / 1e9:.4f} s, rss {cell['max_rss_kb'] // 1024} MB "
                    f"(from {cell['max_rss_source']}); phases "
                    f"(s) {ph}; join launches {cell.get('launches')}")
                if cell["algorithm"] == "device":
                    check({"cuda_init_ns", "kernel_load_ns", "upload_ns", "warm_ns"}
                          <= set(cell["phases"]), "sweep: a device phase is missing")
                    check(cell["launches"].get("rank", 0) > 0, "sweep: the device cell never "
                          "launched the rank mode")
    finally:
        for path in (csv, cells):
            if os.path.exists(path):
                os.remove(path)


def scaling_step() -> None:
    from sview_fmindex_tpu_torch.bench import scaling

    rep = scaling.run_scaling(PAR_TEXT_SIZE, PAR_BATCH, mesh_sizes=[1, 2])
    check(rep["metric"] == "pattern_dp_count_scaling" and rep["platform"] == "gpu"
          and [r["devices"] for r in rep["rows"]] == [1, 2] and rep["virtual"] is True
          and all(r["count_qps"] > 0 for r in rep["rows"]), f"scaling: {rep}")
    log(f"[scaling] {json.dumps(rep)}")


def scaling_report_step() -> None:
    """``tools/torch_scaling_report.py`` at SMOKE_PAR_TEXT_SIZE over 1 and 2
    ranks: weak-scaling rows, the one-rank overhead, the communication model
    beside its measured two-process floor."""
    path = os.path.join(CACHE_DIR, f"scaling_report_{os.getpid()}.json")
    try:
        rep = last_json("scaling_report", run_surface(
            "scaling_report", ["tools/torch_scaling_report.py", "--text-size",
                               str(PAR_TEXT_SIZE), "--ranks", "1,2", "--out", path]))
    finally:
        if os.path.exists(path):
            os.remove(path)
    rows, m = rep["weak_scaling"], rep["comm_model"]
    check(rep["platform"] == "gpu" and rep["virtual"] is True and rep["smi"]
          and [r["devices"] for r in rows] == [1, 2]
          and [r["batch"] for r in rows] == [rep["per_rank_batch"], 2 * rep["per_rank_batch"]]
          and all(r["count_qps"] > 0 for r in rows), f"scaling_report: {rows}")
    check(m["measured_compute_s_per_batch"] > 0 and m["rs_count_all_reduce_bytes"] > 0
          and rep["measured_collective"]["gather_s"] > 0, f"scaling_report: {m}")
    log(f"[scaling_report] {rep['smi']}; weak scaling, {rep['per_rank_batch']} patterns a "
        f"rank: " + ", ".join(f"{r['devices']} rank(s) {r['count_qps'] / 1e6:.3f} Mq/s "
                              f"(efficiency {r['efficiency']})" for r in rows)
        + f"; one-rank sharded count {rep['shard_overhead_rank1']}")
    log(f"[scaling_report] model at B={m['batch']}, 2 ranks: locate {m['measured_compute_s_per_batch'] * 1e3:.2f} ms "
        f"a batch; dp locate gathers {m['dp_locate_gather_bytes']} B (NVLink "
        f"{m['dp_locate_s_nvlink'] * 1e3:.4f} ms, PCIe {m['dp_locate_s_pcie_gen5'] * 1e3:.4f} ms, "
        f"gloo measured {rep['measured_collective']['gather_s'] * 1e3:.2f} ms); rs count "
        f"reduces {m['rs_count_all_reduce_bytes']} B over {m['rs_count_steps']} steps (NVLink "
        f"{m['rs_count_s_nvlink'] * 1e3:.4f} ms; gloo one step "
        f"{rep['measured_collective']['all_reduce_s'] * 1e3:.2f} ms)")


def wide_bench_step() -> None:
    out = run_surface("wide_bench", ["tools/torch_wide_bench.py"],
                      dict(BENCH_TEXT_SIZE=str(TEXT_SIZE)))
    res = last_json("wide_bench", out)
    check(res.get("parity", "").startswith("ok") and res["text_size"] == TEXT_SIZE,
          f"wide_bench: {res.get('parity')}")
    launches = res["launches"]
    log(f"[wide_bench] join launches of its own run, by mode@sigma: {launches}")
    for call in ("count", "locate"):
        check(launches[f"wide-stream {call}"].get("rank_seg@4", 0) > 0,
              f"wide_bench: one wide-stream {call} call launched no segmented rank mode")
    for engine in ("wide-stream", "wide-gather"):
        r = res[engine]
        check(r["count_qps"] > 0 and r["locate_qps"] > 0, f"wide_bench: {engine} rates")
        log(f"[wide_bench] {engine} B={res['batch']}: count "
            f"{span(r['count_qps_worst'], r['count_qps'])} Mq/s, locate "
            f"{span(r['locate_qps_worst'], r['locate_qps'])} Mq/s (host clock, worst-best of 3 "
            f"windows); upload {res['upload_s']} s")


def bench_surfaces_phase(torch, ft, dense_k: int) -> int:
    """Phase 12: every entry point that measures, driven once on the card.
    ``dense_k``: the main path's seed depth, which the micro suite's index
    must share.  Returns the rank-mode launches of the micro suite's ``rank``
    group (the ``join_rank_sigma4`` kernel case's path)."""
    t0 = time.perf_counter()
    bad_symbol_step(torch, ft)
    bench_torch_step()
    rank_launches = micro_step(torch, dense_k)["launches"]["rank"]
    cli_step()
    torch.cuda.empty_cache()
    sweep_step()
    scaling_step()
    scaling_report_step()
    wide_bench_step()
    log(f"[surfaces] all bench surfaces done in {time.perf_counter() - t0:.1f} s")
    return rank_launches


def junit_counts(path: str) -> dict:
    """tests, failures, errors, skipped and seconds per test file from a
    pytest JUnit XML report."""
    import xml.etree.ElementTree as ET

    root = ET.parse(path).getroot()
    suite = root if root.tag == "testsuite" else root.find("testsuite")
    out = {k: int(suite.get(k, 0)) for k in ("tests", "failures", "errors", "skipped")}
    secs = collections.Counter()
    for case in suite.iter("testcase"):
        secs[case.get("classname", "").rsplit(".", 1)[-1] + ".py"] += float(case.get("time", 0))
    out["file_s"] = {k: round(v, 1) for k, v in secs.items()}
    return out


def card_suite_phase() -> dict:
    """Phase 14: the port's card tests (``CARD_SUITE``, ``-m cuda``) in a
    child pytest process.  Every collected test must pass: a failure, an
    error or a skip (no fallback may hide the card) fails the run.  The
    matrix writes its join launches (``SVIEW_CARD_LAUNCHES``): all four modes
    must have launched, and the alphabets of ``CARD_SUITE_SIGMAS`` through an
    engine.  Prints one ``{"card_suite": ...}`` line."""
    work = tempfile.mkdtemp(prefix="sview_card_suite_")
    launches_path = os.path.join(work, "launches.json")
    xml = os.path.join(work, "card.xml")
    args = [sys.executable, "-m", "pytest", *CARD_SUITE, "-m", "cuda", "-q", "--noconftest",
            "-p", "no:cacheprovider"]
    env = dict(os.environ, SVIEW_CARD_LAUNCHES=launches_path,
               PYTHONPATH=REPO_DIR + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    try:
        # the collection runs beside the tests: it needs the host only
        with open(os.path.join(work, "collected.txt"), "w+") as listing:
            lister = subprocess.Popen([*args, "--collect-only"], env=env, cwd=REPO_DIR,
                                      stdout=listing, stderr=subprocess.STDOUT)
            try:
                try:
                    proc = subprocess.run([*args, f"--junitxml={xml}"], env=env, cwd=REPO_DIR,
                                          text=True, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, timeout=CARD_SUITE_DEADLINE)
                except subprocess.TimeoutExpired:  # run() has killed the child
                    raise RuntimeError(f"card suite: still running after {CARD_SUITE_DEADLINE} s")
                lister_rc = lister.wait(timeout=SURFACE_DEADLINE)
            finally:
                if lister.poll() is None:
                    lister.kill()
                    lister.wait()
            secs = time.perf_counter() - t0
            listing.seek(0)
            listed = listing.read()
        counts = junit_counts(xml) if os.path.exists(xml) else {}
        launched = {"launches": {}, "by_sigma": {}}
        if os.path.exists(launches_path):
            with open(launches_path) as f:
                launched = json.load(f)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    collected = sum("::" in ln for ln in listed.splitlines())
    check(lister_rc == 0 and collected > 0, f"card suite: collection failed\n{listed[-3000:]}")
    passed = counts.get("tests", 0) - sum(counts.get(k, 0) for k in ("failures", "errors",
                                                                      "skipped"))
    res = dict(collected=collected, passed=passed, failed=counts.get("failures"),
               errors=counts.get("errors"), skipped=counts.get("skipped"), seconds=round(secs, 1),
               file_s=counts.get("file_s"), exit_code=proc.returncode, **launched)
    log(json.dumps({"card_suite": res}))
    check(proc.returncode == 0 and passed == collected and counts.get("tests")
          and counts["failures"] == counts["errors"] == counts["skipped"] == 0,
          f"card suite: {passed} of {collected} passed\n{proc.stdout[-6000:]}")
    modes = launched["launches"]
    check(all(modes.get(m, 0) > 0 for m in ("rank", "decode", "rank_seg", "decode_seg")),
          f"card suite: a join mode never launched in the matrix: {modes}")
    for sigma in CARD_SUITE_SIGMAS:
        check(any(k.endswith(f"@{sigma}") and n > 0 for k, n in launched["by_sigma"].items()),
              f"card suite: nothing launched at sigma {sigma}")
    log(f"[card_suite] {passed} of {collected} card tests passed in {secs:.1f} s")
    return res


def fresh_store(tag: str) -> str:
    """A path for a ``file://`` rendezvous store that no earlier run left."""
    path = os.path.join(CACHE_DIR, f"store_{tag}_{os.getpid()}")
    os.makedirs(CACHE_DIR, exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    return path


def check_sharded(torch, tag: str, obj, pats_np, want: dict, n: int, rate, reps: int,
                  capacity_kw: str, **call_kw) -> None:
    """One batch through ``obj.count`` and ``obj.locate`` (a ``ShardedFmIndex``
    or ``RangeShardedFmIndex``; ``call_kw`` passed to both): counts equal to
    the unsharded ones exactly, locations equal as sets per pattern, nothing
    dropped; then queries/s of both calls (``rate``: the clock), the locate
    at its auto-sized capacity."""
    B = pats_np.shape[0]
    patterns = torch.from_numpy(pats_np).to(DEVICE)
    counts = obj.count(patterns, None, **call_kw)
    locs, pids, valid, dropped = obj.locate(patterns, None, **call_kw)
    torch.cuda.synchronize()
    check(counts.is_cuda and locs.is_cuda, "a sharded answer is not on the card")
    check(np.array_equal(counts.cpu().numpy(), want["counts"]), f"{tag}: counts != unsharded")
    check(int(dropped.sum()) == 0, f"{tag}: dropped hits at the auto-sized capacity")
    check(np.array_equal(location_sets(locs, pids, valid, n), want["sets"]),
          f"{tag}: location sets != unsharded")
    cap = {capacity_kw: locs.shape[0] // dropped.shape[0]}
    cq = rate(lambda: obj.count(patterns, None, **call_kw), B, reps)
    lq = rate(lambda: obj.locate(patterns, None, **cap, **call_kw), B, reps)
    log(f"[{tag}] B={B}: counts and per-pattern location sets equal the unsharded ones, "
        f"dropped 0; count {max(cq) / 1e6:.3f} Mq/s (worst window {min(cq) / 1e6:.3f}), "
        f"locate {max(lq) / 1e6:.3f} Mq/s (worst window {min(lq) / 1e6:.3f})")


def all_reduce_share(torch, tag: str, obj, pats_np) -> None:
    """The share of one range-sharded locate call spent in ``all_reduce``:
    a call with every collective synchronised and timed on the host clock."""
    from sview_fmindex_tpu_torch.parallel import range_shard

    patterns = torch.from_numpy(pats_np).to(DEVICE)
    obj.locate(patterns, None)
    for k in range_shard.STATS:
        range_shard.STATS[k] = 0
    range_shard.TIME_COLLECTIVES = True
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        obj.locate(patterns, None)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        range_shard.TIME_COLLECTIVES = False
    st = range_shard.STATS
    log(f"[{tag}] B={pats_np.shape[0]} locate, collectives synchronised: {total * 1e3:.2f} ms, "
        f"{st['all_reduce_calls']} all_reduce calls over {st['all_reduce_bytes']} bytes took "
        f"{st['all_reduce_seconds'] * 1e3:.2f} ms: {st['all_reduce_seconds'] / total:.3f} of the call")


def range_sharded_checks(torch, tag: str, fm, mesh, sa_host, batches: dict, rate, reps: int,
                         force_wide: bool = False, **kw) -> None:
    """``RangeShardedFmIndex`` over ``mesh`` with the sampled SA (the
    collective walk) and with the full SA ``sa_host``: this rank holds its
    block range and no more, every batch passes :func:`check_sharded`, and
    no hand kernel is launched (the gather engine serves it).  With
    ``force_wide`` the tables are the wide engine's (int64 SA): the walk
    only, since a wide index refuses ``sa_full`` (a narrow-path option, in
    the JAX package too), which is checked."""
    from sview_fmindex_tpu_torch.ops import stream_join as sj
    from sview_fmindex_tpu_torch.parallel.range_shard import RangeShardedFmIndex

    D = mesh.size("rs")
    if force_wide:
        try:
            RangeShardedFmIndex(fm, mesh, sa_full=sa_host, force_wide=True, **kw)
        except ValueError as exc:
            log(f"[{tag}] sa_full on a wide index: refused ({exc})")
        else:
            raise RuntimeError(f"{tag}: a wide RangeShardedFmIndex took sa_full")
    for sub, sa_full in (("walk", None),) + ((("sa_full", sa_host),) if not force_wide else ()):
        sj.LAUNCHES.clear()
        t0 = time.perf_counter()
        rs = RangeShardedFmIndex(fm, mesh, sa_full=sa_full, force_wide=force_wide, **kw)
        torch.cuda.synchronize()
        n_sa = (sa_host if sa_full is not None else fm.suffix_array).shape[0]
        check(rs.fused.shape[0] == -(-fm.rank_checkpoints.shape[0] // D)
              and rs.sa.shape[0] == -(-n_sa // D), f"{tag}: a rank holds more than its range")
        check(rs.meta.has_sa_full == (sa_full is not None) and rs.meta.wide_pos == force_wide,
              f"{tag}: wrong SA form or width")
        log(f"[{tag} {sub}] staged in {time.perf_counter() - t0:.2f} s: {rs.fused.shape[0]} of "
            f"{fm.rank_checkpoints.shape[0]} fused rows, {rs.sa.shape[0]} of {n_sa} SA entries "
            f"on this rank (rs={D}, dp={rs.dp_size}), dense_k={rs.meta.dense_k}")
        for B, want in batches.items():
            check_sharded(torch, f"{tag} {sub}", rs, want["pats"], want, fm.text_len, rate,
                          reps, "capacity")
        all_reduce_share(torch, f"{tag} {sub}", rs, batches[min(batches)]["pats"])
        check(not sj.LAUNCHES, f"{tag}: range sharding launched a join kernel: {dict(sj.LAUNCHES)}")
        del rs
        torch.cuda.empty_cache()


def wide_sharded_step(torch, ft, fm, main: dict, rate) -> None:
    """``ShardedFmIndex`` over the blob uploaded ``force_wide`` (the second
    wide step of the JAX package's multichip dry run): the wide stream engine
    per shard, answers equal to the narrow main path's, and the segmented
    rank mode launched."""
    from sview_fmindex_tpu_torch.ops import stream_join as sj
    from sview_fmindex_tpu_torch.parallel.mesh import make_mesh
    from sview_fmindex_tpu_torch.parallel.query import ShardedFmIndex

    sj.LAUNCHES.clear()
    sj.LAUNCHES_BY_SIGMA.clear()
    wdev = upload(torch, ft, fm, "par1 dp wide", force_wide=True)
    check(wdev.meta.wide_pos and wdev.stream_tbl is not None, "not a wide stream index")
    wsh = ShardedFmIndex(wdev, make_mesh(axis="dp"))
    for B, want in main["batches"].items():
        check_sharded(torch, "par1 dp wide", wsh, want["pats"], want, fm.text_len, rate,
                      max(8, min(32, int(4e6 // B))), "capacity_per_shard", use_stream=True)
    launches = dict(sj.LAUNCHES_BY_SIGMA)
    log(f"[par1 dp wide] join launches by (mode, sigma): {launches}")
    check(launches.get(("rank_seg", fm.symbol_count), 0) > 0,
          "a wide ShardedFmIndex never launched the segmented rank mode")
    check(not sj.LAUNCHES.get("rank") and not sj.LAUNCHES.get("decode"),
          "a wide ShardedFmIndex launched a narrow join mode")
    del wsh, wdev
    torch.cuda.empty_cache()


def parallel_one_rank_phase(torch, main: dict) -> None:
    """Phase 10: a one-rank NCCL group in this process, both sharded classes
    over the main path's index and blob, narrow and wide."""
    import sview_fmindex_tpu_torch as ft
    from sview_fmindex_tpu_torch.ops import stream_join as sj
    from sview_fmindex_tpu_torch.parallel import distributed
    from sview_fmindex_tpu_torch.parallel.mesh import make_mesh
    from sview_fmindex_tpu_torch.parallel.query import ShardedFmIndex

    fm, dev = main["fm"], main["dev"]
    store = fresh_store("one")
    rt = distributed.initialize(f"file://{store}", 1, 0, timeout=PAR_GROUP_TIMEOUT)
    try:
        check(rt.backend == "nccl" and rt.device.type == DEVICE,
              f"one rank with a GPU of its own is not on NCCL: {rt}")
        log(f"[par1] one rank, backend {rt.backend}, device {rt.device}")

        def cuda_rate(fn, B, reps):
            return measure(fn, B, reps, windows=3)

        sj.LAUNCHES.clear()
        sj.LAUNCHES_BY_SIGMA.clear()
        sh = ShardedFmIndex(dev, make_mesh(axis="dp"))
        check(sh.index.fused.data_ptr() == dev.fused.data_ptr(), "replicate copied a resident index")
        for B, want in main["batches"].items():
            check_sharded(torch, "par1 dp", sh, want["pats"], want, fm.text_len, cuda_rate,
                          max(8, min(32, int(4e6 // B))), "capacity_per_shard")
        launches = dict(sj.LAUNCHES_BY_SIGMA)
        log(f"[par1 dp] join launches by (mode, sigma): {launches}")
        check(launches.get(("rank", 16), 0) > 0, "ShardedFmIndex never launched the rank mode")

        sa_host = dev.sa.cpu().numpy().view(np.uint32)  # the device-filled full SA
        range_sharded_checks(torch, "par1 rs", fm, make_mesh(axis="rs"), sa_host,
                             main["batches"], cuda_rate, 4)
        # the two wide steps of the JAX package's multichip dry run
        range_sharded_checks(torch, "par1 rs wide", fm, make_mesh(axis="rs"), sa_host,
                             main["batches"], cuda_rate, 4, force_wide=True)
        wide_sharded_step(torch, ft, fm, main, cuda_rate)
    finally:
        distributed.shutdown()
        if os.path.exists(store):
            os.remove(store)


def rank_main(rank: int, world: int, store: str) -> None:
    """One rank of phase 11 (a child process of :func:`two_rank_phase`)."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's smoke run needs a GPU")
    import sview_fmindex_tpu_torch as ft
    from sview_fmindex_tpu_torch.ops import stream_join as sj
    from sview_fmindex_tpu_torch.parallel import distributed
    from sview_fmindex_tpu_torch.parallel.mesh import make_mesh
    from sview_fmindex_tpu_torch.parallel.query import ShardedFmIndex

    tag = f"par{world} r{rank}"
    rt = distributed.initialize(f"file://{store}", world, rank, timeout=PAR_GROUP_TIMEOUT)
    check(rt.backend == "gloo" and rt.device == torch.device("cuda", 0),
          f"{world} ranks on one card are not on gloo and cuda:0: {rt}")
    text = get_text(PAR_TEXT_SIZE)
    fm = get_blob(ft, text)
    dev = upload(torch, ft, fm, tag, dense_lut_entries=1 << 28, dense_host_entries=1 << 20,
                 sa_full="device", sa_fill_ratio=4)
    rng = np.random.default_rng(SEED + 9)
    starts = rng.integers(0, PAR_TEXT_SIZE - PATTERN_LEN, size=PAR_BATCH)
    pats_np = np.ascontiguousarray(text[starts[:, None] + np.arange(PATTERN_LEN)])
    patterns = torch.from_numpy(pats_np).to(DEVICE)
    counts = dev.count(patterns, use_stream=True)
    locs, pids, valid, dropped = dev.locate(patterns, use_stream=True)
    check(int(dropped[0]) == 0 and bool((counts >= 1).all()), f"{tag}: unsharded answers")
    batches = {PAR_BATCH: dict(pats=pats_np, counts=counts.cpu().numpy(),
                               sets=location_sets(locs, pids, valid, fm.text_len))}

    def rate(fn, B, reps):
        return measure(fn, B, reps, windows=3, clock="host")

    uq = rate(lambda: dev.count(patterns, use_stream=True), PAR_BATCH, 8)
    log(f"[{tag}] unsharded on this rank while its peers run too: count "
        f"{max(uq) / 1e6:.3f} Mq/s (worst window {min(uq) / 1e6:.3f}), host clock")
    sj.LAUNCHES.clear()
    sj.LAUNCHES_BY_SIGMA.clear()
    sh = ShardedFmIndex(dev, make_mesh(axis="dp"))
    check(sh.n_devices == world, f"{tag}: dp mesh of {sh.n_devices}")
    check_sharded(torch, f"{tag} dp", sh, pats_np, batches[PAR_BATCH], fm.text_len, rate, 8,
                  "capacity_per_shard")
    launches = dict(sj.LAUNCHES_BY_SIGMA)
    log(f"[{tag} dp] join launches by (mode, sigma) on this rank: {launches}")
    check(launches.get(("rank", 16), 0) > 0, f"{tag}: this rank never launched the rank mode")
    sa_host = dev.sa.cpu().numpy().view(np.uint32)
    del sh, dev
    torch.cuda.empty_cache()
    range_sharded_checks(torch, f"{tag} rs", fm, make_mesh(axis="rs"), sa_host, batches, rate, 4)
    range_sharded_checks(torch, f"{tag} rs wide", fm, make_mesh(axis="rs"), sa_host, batches,
                         rate, 4, force_wide=True)
    range_sharded_checks(torch, f"{tag} rs x dp", fm,
                         make_mesh(shape=(world, 1), axes=("rs", "dp")), sa_host, batches,
                         rate, 4, dp_axis="dp")
    check("jax" not in sys.modules, f"{tag}: the port imported JAX")
    check("sview_fmindex_tpu" not in sys.modules, f"{tag}: the port imported the JAX package")
    distributed.shutdown()
    log(f"[{tag}] done")


def two_rank_phase(ft) -> None:
    """Phase 11: two child processes, both on cuda:0.  Their output is shown;
    a child that fails, or runs past the deadline, is killed and fails the
    run."""
    world = 2
    get_blob(ft, get_text(PAR_TEXT_SIZE))  # built once, before the ranks look for it
    store = fresh_store("two")
    outs = [os.path.join(CACHE_DIR, f"rank{r}_{os.getpid()}.out") for r in range(world)]
    procs = []
    failed = None
    t0 = time.monotonic()
    try:
        for r in range(world):
            with open(outs[r], "wb") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--rank", str(r), str(world),
                     store], stdout=f, stderr=subprocess.STDOUT))
        pending = set(range(world))
        while pending and failed is None:
            for r in sorted(pending):
                rc = procs[r].poll()
                if rc is not None:
                    pending.discard(r)
                    if rc != 0:
                        failed = f"rank {r} exited with code {rc}"
            if pending and time.monotonic() - t0 > PAR_CHILD_DEADLINE:
                failed = f"ranks {sorted(pending)} still running after {PAR_CHILD_DEADLINE} s"
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for r in range(world):
            if os.path.exists(outs[r]):
                with open(outs[r], errors="replace") as f:
                    sys.stdout.write(f.read())
                os.remove(outs[r])
        sys.stdout.flush()
        if os.path.exists(store):
            os.remove(store)
    check(failed is None, f"two-rank run: {failed}")
    log(f"[par2] both ranks done in {time.monotonic() - t0:.1f} s")


def build_main(position: str) -> None:
    """The build child of phase 13 (``chip_smoke.py --build-wide``: a u64
    blob over WIDE_TEXT_SIZE bp) or phase 15 (``--build-narrow``: a u32 blob
    over NARROW_TEXT_SIZE bp): the text and its blob, cached under
    ``bench_cache/``.  Prints when each build pass starts and how long it
    took, and its own peak RSS before the build (the package import) and
    after each pass."""
    import resource

    import sview_fmindex_tpu_torch as ft
    from sview_fmindex_tpu_torch.build import bwm, bwt, count_array

    size, tag = ((WIDE_TEXT_SIZE, "wide_build") if position == "u64"
                 else (NARROW_TEXT_SIZE, "narrow_build"))

    def timed(mod, name):
        fn = getattr(mod, name)

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            log(f"[{tag}] {name} starts at {time.time() - T_START:.0f} s")
            out = fn(*args, **kwargs)
            log(f"[{tag}] {name}: {time.perf_counter() - t0:.1f} s, peak RSS so far "
                f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB")
            return out
        setattr(mod, name, wrapper)

    for mod, name in ((count_array, "encode_text"), (count_array, "count_and_kmer_tables"),
                      (bwt, "suffix_array"), (bwt, "bwt_and_sampled_sa"),
                      (bwm, "write_bwm_body")):
        timed(mod, name)
    t0 = time.perf_counter()
    text = get_text(size)
    log(f"[{tag}] text of {size} bp ready in {time.perf_counter() - t0:.1f} s; "
        f"peak RSS before the build {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f}"
        f" GiB")
    get_blob(ft, text, position=position)


def opt_in_sizes(narrow: int, wide: int) -> None:
    """Refuse an opt-in text outside its range (phase 15's narrow one inside
    NARROW_RANGE, phase 13's above 2^32), and both in one run: their two
    builds do not fit one host together."""
    if narrow:
        check(NARROW_RANGE[0] < narrow < NARROW_RANGE[1],
              f"SMOKE_NARROW_TEXT_SIZE must lie in (2^31 + 2^20, 2^32), not {narrow}")
        check(not wide, "SMOKE_NARROW_TEXT_SIZE and SMOKE_WIDE_TEXT_SIZE cannot share a run: "
              "their two builds do not fit one host together")
    if wide:
        check(wide > 2**32 + 2**20, "SMOKE_WIDE_TEXT_SIZE must exceed 2^32")


def start_build(position: str):
    """An opt-in phase's build (``u64``: phase 13, ``u32``: phase 15),
    started before phase 3 so that it runs beside the earlier phases: a child
    process of this script."""
    flag = "--build-wide" if position == "u64" else "--build-narrow"
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), flag], cwd=REPO_DIR)


def wait_build(proc, size: int, tag: str) -> None:
    """Wait for a build child; its peak RSS is its ``ru_maxrss`` from
    ``os.wait4``: the ``getrusage(RUSAGE_CHILDREN)`` figure of that child
    alone (other children of this script run beside it)."""
    t0 = time.perf_counter()
    _, status, ru = os.wait4(proc.pid, 0)
    proc.returncode = os.waitstatus_to_exitcode(status)
    peak = ru.ru_maxrss * 1024
    log(f"[{tag}] build child exited {proc.returncode} after {time.perf_counter() - t0:.1f} s "
        f"of waiting, {time.time() - T_START:.0f} s after the start; its peak RSS "
        f"{peak / 2**30:.2f} GiB = {peak / size:.2f} B/bp (the mapped text and blob pages it "
        f"touched included)")
    check(proc.returncode == 0, f"the {tag} build child exited {proc.returncode}")


def find_all(mm, pat: bytes) -> list[int]:
    """Every position of ``pat`` in the mapped text, by scanning it."""
    out, i = [], mm.find(pat)
    while i >= 0:
        out.append(i)
        i = mm.find(pat, i + 1)
    return out


def scan_text(text, pats, tag: str, *above: int) -> list[list[int]]:
    """Every position of each pattern (uint8 [P, L]) in the raw text, by
    scanning the mapped file: an oracle that reads no table of the index.
    Logs how many positions lie at or above each bound of ``above``."""
    import mmap

    t0 = time.perf_counter()
    with open(text.filename, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        scan = [find_all(mm, p.tobytes()) for p in pats]
    counts = "".join(f", {sum(p >= a for v in scan for p in v)} at or above {a}" for a in above)
    log(f"[{tag}] {len(scan)} patterns scanned for in the raw text in "
        f"{time.perf_counter() - t0:.1f} s: {sum(map(len, scan))} positions{counts}")
    return scan


def scan_check(torch, dev, tag: str, pats, scan: list) -> None:
    """``dev``'s counts and locations of ``pats`` (through the stream
    engine) equal the raw-text scan's."""
    q = torch.from_numpy(np.ascontiguousarray(pats)).to(DEVICE)
    counts = dev.count(q, use_stream=True).cpu().numpy()
    locs, pids, valid, dropped = dev.locate(q, use_stream=True)
    check(int(dropped[0]) == 0, "the scan patterns dropped hits")
    got = [[] for _ in scan]
    for loc, p in zip(locs[valid].cpu().numpy(), pids[valid].cpu().numpy()):
        got[int(p)].append(int(loc))
    for j, want in enumerate(scan):
        check(int(counts[j]) == len(want) and sorted(got[j]) == want,
              f"{tag}: pattern {j} differs from the scan of the text")
    log(f"[{tag}] the counts and locations of the {len(scan)} patterns equal the scan")


def wide_text_phase(torch, ft, build) -> list[dict]:
    """Phase 13: the u64 blob over WIDE_TEXT_SIZE bp (built by ``build``, the
    child process), served without force_wide by the wide engine and by
    ``tools/torch_wide_scale_check.py``; 16 of the tool's patterns held
    against a scan of the raw text by both."""
    import importlib.util

    wait_build(build, WIDE_TEXT_SIZE, "wide_text")
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

    tool_path = os.path.join(REPO_DIR, "tools", "torch_wide_scale_check.py")
    spec = importlib.util.spec_from_file_location("torch_wide_scale_check", tool_path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    n_pats = 256
    starts, pats = tool.draw_patterns(text, n_pats, PATTERN_LEN, 123)
    picked = [*range(8), *range(n_pats // 2, n_pats // 2 + 8)]  # 8 below 2^32, 8 above
    scan = dict(zip(picked, scan_text(text, pats[picked], "wide_text", 2**32)))

    sigma = fm.symbol_count
    _, kernels = wide_checks(
        torch, ft, fm, text, "wide_text", batches,
        kernel_cases_of=lambda dev: [("join_rank_seg_u64", dev.stream_tbl, sigma, False),
                                     ("join_decode_seg_u64", dev.stream_tbl, sigma, True)],
        on_index=lambda dev: scan_check(torch, dev, "wide_text", pats[picked],
                                        [scan[i] for i in picked]))
    del fm
    torch.cuda.empty_cache()

    out = os.path.join(CACHE_DIR, f"wide_scale_{os.getpid()}.json")
    try:
        last_json("wide_scale", run_surface(
            "wide_scale", ["tools/torch_wide_scale_check.py", "--text", text.filename,
                           "--blob", blob_path(WIDE_TEXT_SIZE, "u64"), "--out", out],
            deadline=WIDE_SCALE_DEADLINE))
        with open(out) as f:
            rep = json.load(f)
    finally:
        if os.path.exists(out):
            os.remove(out)
    ans = rep.pop("answers")
    log(f"[wide_scale] {json.dumps(rep)}")
    check(rep["ok"] and rep["mismatches"] == 0 and rep["locations_above_2_32"] > 0
          and ans["starts"] == starts.tolist(), "the scale check failed")
    for i in picked:
        check(ans["counts"][i] == len(scan[i]) and ans["locations"][i] == scan[i],
              f"range-sharded: pattern {i} differs from the scan of the text")
    log(f"[wide_scale] the range-sharded counts and locations of the {len(picked)} scanned "
        f"patterns equal the scan")
    return kernels


def fill_budget_check(mem: dict, n: int) -> None:
    """The upload's SA fill ran in slices (``build/sa_fill.STATS``) and its
    phase's device peak stayed within ``sa_fill.fill_budget`` above the
    memory resident when the phase began (the end of the ``pair`` phase)."""
    from sview_fmindex_tpu_torch.build import sa_fill

    stats = dict(sa_fill.STATS)
    before = mem["resident"]["pair"]
    extra = mem["peaks"]["sa_fill"] - before
    budget = sa_fill.fill_budget(n, stats["chains"])
    log(f"[narrow_text] SA fill: {stats['chains']} chains in {stats['slices']} slices of at most "
        f"{sa_fill._FILL_CHAINS}, live width {stats['live_width']}, {stats['rounds']} rounds; "
        f"peak {mem['peaks']['sa_fill'] / 2**30:.2f} GiB = {before / 2**30:.2f} resident before "
        f"+ {extra / 2**30:.2f}, budget {budget / 2**30:.2f} GiB (the int32 SA "
        f"{4 * n / 2**30:.2f} + {min(stats['chains'], sa_fill._FILL_CHAINS)} chains x "
        f"{sa_fill.CHAIN_BYTES} B)")
    check(stats["slices"] == -(-stats["chains"] // sa_fill._FILL_CHAINS)
          and stats["live_width"] <= sa_fill._FILL_CHAINS, "the SA fill did not run in slices")
    check(extra <= budget, f"the SA fill held {extra} bytes above the resident memory, over its "
          f"budget of {budget}")


def top_seed_check(torch, dev, text) -> None:
    """The dense seed of the last k-mer (dense_k times the last symbol, T):
    its range ends at n, the word that reads -1 as int32 at n = 2^32 - 1.
    That k-mer alone and a 20-bp pattern that starts with it, against the
    scan of the raw text."""
    n = text.shape[0]
    dk = dev.meta.dense_k
    run = np.full((1, dk), ord("T"), np.uint8)
    occ = scan_text(text, run, "narrow_text")[0]
    check(len(occ) > 0, f"T^{dk} does not occur in the text")
    lo, hi = dev.pos_ranges(torch.from_numpy(run).to(DEVICE), use_stream=True)
    check(int(hi[0]) == n and int(hi[0]) - int(lo[0]) == len(occ),
          f"the range of T^{dk} is [{int(lo[0])}, {int(hi[0])}), not [n - {len(occ)}, n)")
    scan_check(torch, dev, "narrow_text", run, [occ])
    p = next((p for p in occ if p + PATTERN_LEN <= n), None)
    check(p is not None, f"no occurrence of T^{dk} is followed by {PATTERN_LEN - dk} bp")
    pat = np.array(text[p:p + PATTERN_LEN])[None]
    want = [q for q in occ
            if q + PATTERN_LEN <= n and bytes(text[q:q + PATTERN_LEN]) == pat.tobytes()]
    scan_check(torch, dev, "narrow_text", pat, [want])
    log(f"[narrow_text] the dense seed of T^{dk} is [{int(lo[0])}, {n}): its {len(occ)} "
        f"occurrences and the {len(want)} of a 20-bp pattern starting with it equal the scan")


def narrow_text_phase(torch, ft, build) -> list[dict]:
    """Phase 15: the u32 blob over NARROW_TEXT_SIZE bp, between 2^31 and
    2^32 (built by ``build``, the child process), uploaded as the bench
    uploads it and served by the narrow engine, its tables' words past 2^31
    negative as int32: the SA fill against the blob and the raw text and
    within its memory budget, the batches with half their starts above 2^31,
    16 patterns and the dense seed whose range ends at n against a scan of
    the raw text, the kernel on the real tables, then the walk upload.  At
    NARROW_TOP and above, keys, positions and rows that high are held too."""
    from sview_fmindex_tpu_torch.ops import stream_join as sj

    size = NARROW_TEXT_SIZE
    top = size >= NARROW_TOP
    bounds = (NARROW_HIGH, NARROW_TOP) if top else (NARROW_HIGH,)
    wait_build(build, size, "narrow_text")
    text = get_text(size)
    t0 = time.perf_counter()
    fm = get_blob(ft, text)
    log(f"[narrow_text] text {size} bp, u32 blob ready in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 14)
    batches = {}
    for B in BATCHES:  # half the patterns start above 2^31
        starts = np.concatenate([rng.integers(0, size - PATTERN_LEN, size=B // 2),
                                 rng.integers(NARROW_HIGH, size - PATTERN_LEN, size=B - B // 2)])
        batches[B] = dict(pats=np.ascontiguousarray(text[starts[:, None] + np.arange(PATTERN_LEN)]))
    # 8 below 2^31 and 8 above; at the top, 4 of those from NARROW_TOP on
    starts = np.concatenate([rng.integers(0, NARROW_HIGH, size=8)] + (
        [rng.integers(NARROW_HIGH, NARROW_TOP, size=4),
         rng.integers(NARROW_TOP, size - PATTERN_LEN, size=4)] if top
        else [rng.integers(NARROW_HIGH, size - PATTERN_LEN, size=8)]))
    scan_pats = np.ascontiguousarray(text[starts[:, None] + np.arange(PATTERN_LEN)])
    scan = scan_text(text, scan_pats, "narrow_text", *bounds)

    sj.LAUNCHES.clear()
    sj.LAUNCHES_BY_SIGMA.clear()
    mem = {}
    dev = upload(torch, ft, fm, "narrow_text", mem=mem, **bench_torch.UPLOAD_KW)
    check(not dev.meta.wide_pos and dev.meta.has_sa_full and dev.meta.pair_rows > 0,
          "the narrow text did not upload to the narrow engine with the full SA and pair table")
    fill_budget_check(mem, size)
    sa_fill_check(torch, fm, dev, "narrow_text")
    sa_order_check(torch, dev, text, "narrow_text", rng)
    for B, want in batches.items():
        counts, sets, out, _ = run_batch(torch, fm, dev, text, "narrow_text", want["pats"],
                                         "pair-stream")
        want.update(counts=counts, sets=sets)
        locs, _, valid = out[:3]
        lo, hi = dev.pos_ranges(torch.from_numpy(want["pats"]).to(DEVICE), use_stream=True)
        for bound in bounds:
            above = int((locs[valid] >= bound).sum())
            lo_hi, hi_hi = int((lo >= bound).sum()), int((hi >= bound).sum())
            log(f"[narrow_text] B={B}: {above} of {int(valid.sum())} located positions, {lo_hi} "
                f"lo and {hi_hi} hi rows of {B} ranges at or above {bound}")
            check(above > 0 and lo_hi > 0 and hi_hi > 0,
                  f"no located position or range row at or above {bound}")
    scan_check(torch, dev, "narrow_text", scan_pats, scan)
    top_seed_check(torch, dev, text)
    by_sigma = dict(sj.LAUNCHES_BY_SIGMA)
    log(f"[narrow_text] kernel launches: {dict(sj.LAUNCHES)}; by (mode, sigma): {by_sigma}")
    check(by_sigma.get(("rank", 16), 0) > 0, "the pair chain never launched rank@16")
    check(by_sigma.get(("decode", 4), 0) > 0, "the SA fill never launched decode@4")
    check(not sj.LAUNCHES.get("rank_seg") and not sj.LAUNCHES.get("decode_seg"),
          "a narrow index launched a segmented join mode")
    kernels = kernel_cases(
        torch, dev, np.random.default_rng(SEED + 15),
        [("join_rank_pair_narrow_hi", dev.pair_tbl, 16, False),
         ("join_decode_narrow_hi", dev.stream_tbl, 4, True)], by_sigma,
        high_from=(NARROW_HIGH, size - NARROW_TOP_KEYS) if top else (NARROW_HIGH,))
    del dev
    torch.cuda.empty_cache()

    # the walk: the sampled SA and the LF walk's kernel
    from sview_fmindex_tpu_torch.ops import locate

    sj.LAUNCHES.clear()
    sj.LAUNCHES_BY_SIGMA.clear()
    locate.LAUNCHES.clear()
    dev = upload(torch, ft, fm, "narrow_walk", dense_lut_entries=1 << 28,
                 dense_host_entries=1 << 20)
    check(not dev.meta.wide_pos and not dev.meta.has_sa_full,
          "the walk upload is not narrow with the sampled SA")
    want = batches[WALK_BATCH]
    counts, sets, _, _ = run_batch(torch, fm, dev, text, "narrow_walk", want["pats"],
                                   "pair-stream")
    check(np.array_equal(counts, want["counts"]), "walk counts != the full-SA upload's")
    check(np.array_equal(sets, want["sets"]), "walk location sets != the full-SA upload's")
    log(f"[narrow_walk] B={WALK_BATCH}: counts and location sets equal the full-SA upload's; "
        f"walk kernel launches {dict(locate.LAUNCHES)}, join launches by (mode, sigma): "
        f"{dict(sj.LAUNCHES_BY_SIGMA)}")
    check(locate.LAUNCHES["walk"] > 0, "the walk never launched its kernel")
    check(not sj.LAUNCHES.get("decode"), "the walk launched the join's decode mode")
    del dev
    torch.cuda.empty_cache()
    return kernels


def main() -> None:
    import torch

    opt_in_sizes(NARROW_TEXT_SIZE, WIDE_TEXT_SIZE)
    smi = device_phase(torch)
    build = (start_build("u64") if WIDE_TEXT_SIZE
             else start_build("u32") if NARROW_TEXT_SIZE else None)
    try:
        kernels = smoke(torch, build)
    finally:
        if build is not None and build.returncode is None:
            build.kill()
            build.wait()
    check("jax" not in sys.modules, "the port imported JAX")
    check("sview_fmindex_tpu" not in sys.modules, "the port imported the JAX package")
    log(f"[done] {time.time() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def smoke(torch, build) -> list[dict]:
    """Phases 2-15; returns the kernel summary.  ``build``: the child
    building the opt-in text's blob (phase 13 or 15), or None."""
    import sview_fmindex_tpu_torch as ft

    build_phase()
    main_res = main_path(torch, ft)
    parallel_one_rank_phase(torch, main_res)
    kernels = gather_search_phase(torch, main_res["dev"], main_res["text"],
                                  main_res["gather_per_call"])
    kernels += kernel_phase(torch, main_res.pop("dev"), main_res["by_sigma"])
    torch.cuda.empty_cache()
    fm, text = main_res["fm"], main_res["text"]
    wide_launches, _ = wide_checks(torch, ft, fm, text, "wide", main_res["batches"],
                                   force_wide=True)
    kernels += walk_phase(torch, ft, fm, text, main_res)
    kernels += segmented_kernel_phase(torch, wide_launches)
    kernels += hbm_kernel_phase(torch, main_res["by_sigma"])
    kernels += hi_ckpt_phase(torch, main_res["by_sigma"])
    unfilled_scan_phase(torch)
    ragged_phase(torch)
    dense_k = main_res["dense_k"]
    del main_res, fm, text
    kernels += protein_phase(torch, ft)
    kernels += wildcard_phase(torch, ft)
    torch.cuda.empty_cache()
    rank4 = next(k for k in kernels if k["name"] == "join_rank_sigma4")
    rank4["launches"] = bench_surfaces_phase(torch, ft, dense_k)
    torch.cuda.empty_cache()
    card_suite_phase()
    two_rank_phase(ft)
    if WIDE_TEXT_SIZE:
        kernels += wide_text_phase(torch, ft, build)
    elif NARROW_TEXT_SIZE:
        kernels += narrow_text_phase(torch, ft, build)
    return kernels


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--rank":
        rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:] == ["--build-wide"]:
        build_main("u64")
    elif sys.argv[1:] == ["--build-narrow"]:
        build_main("u32")
    else:
        main()
