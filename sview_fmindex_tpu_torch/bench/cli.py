"""Benchmark CLI of the PyTorch/CUDA port (port of
``sview_fmindex_tpu.bench.cli``): subcommand parity with the reference bench
tool (``bench/src/main.rs:15-127``), same flags and the same printed lines.

- ``generate-text``     seeded ACGT text -> text.txt
- ``generate-pattern``  cold/warm patterns from the text -> pattern.txt
  (cold = fresh substrings, warm = repeats of cold, ``generate.rs:56-144``)
- ``build``             build and save the index blob
  (ACGT + T-as-wildcard -> Block2, else ACGTN -> Block3,
  ``build/mod.rs:28-30``, ``build/sview_memory.rs:22-47``)
- ``locate``            load blob, stream patterns, write per-pattern
  comma-joined locations, print phase timings in ns
  (``locate/mod.rs:51-124``)

- ``scaling``           pattern-DP scaling report (``bench/scaling.py``)

Algorithms: ``memory`` (fs read + host engine), ``mmap`` (np.memmap +
host engine), ``device`` (fs read + the batched ``DeviceFmIndex``, on the
current CUDA device; ``--device cpu`` names the CPU, and with neither a card
nor that flag it raises).  Blob stems keep the reference's naming, and the
text, pattern, blob and result files are byte-identical with the JAX
package's CLI, so files interoperate.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

SYMBOLS_ACGT = [b"Aa", b"Cc", b"Gg", b"Tt"]
SYMBOLS_ACGTN = [b"Aa", b"Cc", b"Gg", b"Tt", b"Nn"]


def _now() -> int:
    return time.perf_counter_ns()


def generate_text(args) -> None:
    t0 = _now()
    os.makedirs(args.data_dir, exist_ok=True)
    path = os.path.join(args.data_dir, "text.txt")
    if os.path.exists(path) and not args.overwrite:
        print(f"Text file already exists: {path}")
        print("Use --overwrite to overwrite.")
        return
    rng = np.random.default_rng(args.seed)
    text = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=args.text_length)
    text.tofile(path)
    print(f"Text file created: {path}")
    print(f"Total time: {_now() - t0} ns")


def generate_pattern(args) -> None:
    t0 = _now()
    text_path = os.path.join(args.data_dir, "text.txt")
    if not os.path.exists(text_path):
        sys.exit(f"Text file not found: {text_path}. Run generate-text first.")
    path = os.path.join(args.data_dir, "pattern.txt")
    if os.path.exists(path) and not args.overwrite:
        print(f"Pattern file already exists: {path}")
        print("Use --overwrite to overwrite.")
        return
    text = np.fromfile(text_path, dtype=np.uint8)
    rng = np.random.default_rng(args.seed)
    cold_count = min(int(np.ceil(args.cold_ratio * args.pattern_count)), args.pattern_count)
    warm_count = args.pattern_count - cold_count
    print(f"Cold patterns: {cold_count} (new)")
    print(f"Warm patterns: {warm_count} (repeated)")
    max_start = len(text) - args.pattern_length
    starts = rng.integers(0, max_start + 1, size=cold_count)
    cold = [text[s : s + args.pattern_length].tobytes() for s in starts]
    warm = [cold[i % cold_count] for i in range(warm_count)] if cold_count else []
    with open(path, "wb") as f:
        f.write(b"\n".join(cold + warm))
    print(f"Pattern file created: {path}")
    print(f"Total time: {_now() - t0} ns")


def _configs(args):
    from .. import (
        BlockKind,
        EncodingTable,
        LookupTableConfig,
        SuffixArrayConfig,
    )

    symbols = SYMBOLS_ACGT if args.treat_t_as_wildcard else SYMBOLS_ACGTN
    block = BlockKind(2, 64) if args.treat_t_as_wildcard else BlockKind(3, 64)
    enc = EncodingTable.from_symbols(symbols)
    sa_cfg = None if args.sasr == 1 else SuffixArrayConfig.compressed(args.sasr)
    lut_cfg = None if args.klts == 1 else LookupTableConfig.kmer_size(args.klts)
    return enc, block, sa_cfg, lut_cfg


def _blob_stem(algorithm: str, treat_t_as_wildcard: bool) -> str:
    block_name = "block2" if treat_t_as_wildcard else "block3"
    kind = "mmap" if algorithm == "mmap" else "memory"
    return f"sview-{kind}-{block_name}"


def build(args) -> None:
    from .. import FmIndexBuilder

    t0 = _now()
    text_path = os.path.join(args.data_dir, "text.txt")
    if not os.path.exists(text_path):
        sys.exit(f"Text file not found: {text_path}")
    text = np.fromfile(text_path, dtype=np.uint8)
    print(f"Loaded text: {len(text)} bytes")
    enc, block, sa_cfg, lut_cfg = _configs(args)
    builder = FmIndexBuilder(
        len(text), enc.symbol_count(), enc, position="u32", block=block,
        suffix_array_config=sa_cfg, lookup_table_config=lut_cfg,
    )
    stem = _blob_stem(args.algorithm, args.treat_t_as_wildcard)
    blob_path = os.path.join(args.data_dir, f"{stem}.blob")
    build_start = _now()
    if args.algorithm == "mmap":
        # build directly into a file-backed buffer (bench/src/build/sview_mmap.rs)
        mm = np.memmap(blob_path, dtype=np.uint8, mode="w+", shape=(builder.blob_size(),))
        builder.build(text, mm)
        mm.flush()
    else:
        blob = builder.build(text)
        with open(blob_path, "wb") as f:
            f.write(blob)
    print(f"Build time: {_now() - build_start} ns")
    print(f"Blob saved to: {blob_path} ({builder.blob_size()} bytes)")
    print(f"Total time: {_now() - t0} ns")


def locate(args) -> None:
    from .. import FmIndex

    t0 = _now()
    pattern_path = os.path.join(args.data_dir, "pattern.txt")
    if not os.path.exists(pattern_path):
        sys.exit(f"Pattern file not found: {pattern_path}")
    enc, block, _, _ = _configs(args)

    stem = _blob_stem(args.algorithm, args.treat_t_as_wildcard)
    blob_path = os.path.join(args.data_dir, f"{stem}.blob")
    if not os.path.exists(blob_path):
        sys.exit(f"Blob file not found: {blob_path}. Run build first.")

    load_start = _now()
    if args.algorithm == "mmap":
        blob = np.memmap(blob_path, dtype=np.uint8, mode="r")
        # reference parity: MMAP_ADVICE_{RANDOM,SEQUENTIAL,DONTDUMP} env
        # toggles (bench/src/locate/sview_mmap.rs:27-43)
        import mmap as _mmap

        def _env_on(name: str) -> bool:
            # '0'/''/'false' count as unset (reference checks presence of a
            # meaningfully-set var, not raw string truthiness)
            return os.environ.get(name, "").lower() not in ("", "0", "false")

        mm = getattr(blob, "_mmap", None)
        if mm is not None and hasattr(mm, "madvise"):
            if _env_on("MMAP_ADVICE_RANDOM"):
                mm.madvise(_mmap.MADV_RANDOM)
            elif _env_on("MMAP_ADVICE_SEQUENTIAL"):
                mm.madvise(_mmap.MADV_SEQUENTIAL)
            elif _env_on("MMAP_ADVICE_DONTDUMP") and hasattr(_mmap, "MADV_DONTDUMP"):
                mm.madvise(_mmap.MADV_DONTDUMP)
    else:
        blob = np.fromfile(blob_path, dtype=np.uint8)
    fm = FmIndex.load(blob, position="u32", block=block, encoder_kind="table")
    load_time = _now() - load_start
    print(f"Blob loading time: {load_time} ns")

    with open(pattern_path, "rb") as f:
        patterns = f.read().split(b"\n")
    result_path = os.path.join(args.data_dir, f"{stem}-results.txt")

    locate_start = _now()
    if args.algorithm == "device":
        from ..utils.patterns import pack_patterns

        batch, lens = pack_patterns(patterns)
        dev = fm.to_device(getattr(args, "device", None))
        locs, pids, valid, _dropped = (t.cpu().numpy() for t in dev.locate(batch, lens))
        # bucket by pattern with one stable sort: a pattern's locations keep
        # their slot order (a Python loop over every slot would be the run)
        order = np.argsort(pids[valid], kind="stable")
        texts = locs[valid][order].astype(str)
        ends = np.cumsum(np.bincount(pids[valid], minlength=len(patterns)))
        with open(result_path, "w") as out:
            a = 0
            for b in ends.tolist():
                out.write(",".join(texts[a:b]) + "\n")
                a = b
        serve = int(getattr(args, "serve", 0) or 0)
        if serve:
            # resident-server mode: the uploaded index serves repeated
            # batches; the amortized number is what a serving deployment
            # sees (the one-shot total above is mostly load)
            from .timing import force as _force

            s0 = _now()
            for _ in range(serve):
                out4 = dev.locate(batch, lens)
                _force(out4[0])
            per_batch = (_now() - s0) // serve
            qps = len(patterns) * 1e9 / max(per_batch, 1)
            print(f"Serve mode: {serve} batches, {per_batch} ns/batch "
                  f"({qps:,.0f} locate/s resident)")
    else:
        with open(result_path, "w") as out:
            for pat in patterns:
                row = fm.locate(pat)
                out.write(",".join(map(str, row)) + "\n")
    locate_time = _now() - locate_start
    print(f"Locate processing time: {locate_time} ns")
    print(f"Results saved to: {result_path}")
    total = _now() - t0
    print(f"Locate time: {locate_time} ns")
    print(f"Total time: {total} ns")
    if total:
        print(f"Index Load (%): {100 * load_time // total}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="sview-fmindex-tpu-torch-bench")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("generate",
                       help="legacy: generate both text and patterns "
                            "(bench/src/main.rs:17-38)")
    p.add_argument("-d", "--data-dir", default="test_data")
    p.add_argument("-t", "--text-length", type=int, default=100000)
    p.add_argument("-p", "--pattern-length", type=int, default=20)
    p.add_argument("-n", "--pattern-count", type=int, default=100)
    p.add_argument("-s", "--seed", type=int, default=0)
    p.add_argument("--overwrite", action="store_true")

    def _generate(a):
        a.cold_ratio = 1.0
        generate_text(a)
        generate_pattern(a)
    p.set_defaults(func=_generate)

    p = sub.add_parser("generate-text")
    p.add_argument("-d", "--data-dir", default="test_data")
    p.add_argument("-t", "--text-length", type=int, default=100000)
    p.add_argument("-s", "--seed", type=int, default=0)
    p.add_argument("--overwrite", action="store_true")
    p.set_defaults(func=generate_text)

    p = sub.add_parser("generate-pattern")
    p.add_argument("-d", "--data-dir", default="test_data")
    p.add_argument("-p", "--pattern-length", type=int, default=20)
    p.add_argument("-n", "--pattern-count", type=int, default=100)
    p.add_argument("-c", "--cold-ratio", type=float, default=1.0)
    p.add_argument("-s", "--seed", type=int, default=0)
    p.add_argument("--overwrite", action="store_true")
    p.set_defaults(func=generate_pattern)

    for name, fn in (("build", build), ("locate", locate)):
        p = sub.add_parser(name)
        p.add_argument("-d", "--data-dir", default="test_data")
        p.add_argument("-a", "--algorithm", default="memory",
                       choices=["memory", "mmap", "device"])
        p.add_argument("-s", "--sasr", type=int, default=2)
        p.add_argument("-k", "--klts", type=int, default=3)
        p.add_argument("-t", "--treat-t-as-wildcard", action="store_true")
        if name == "locate":
            p.add_argument("--serve", type=int, default=0, metavar="N",
                           help="after the one-shot run, serve N more "
                                "batches from the resident device index "
                                "and report amortized ns/batch")
            p.add_argument("--device", default=None,
                           help="torch device of the 'device' algorithm "
                                "(default: the current CUDA device)")
        p.set_defaults(func=fn)

    p = sub.add_parser("scaling", help="pattern-DP scaling-efficiency report")
    p.add_argument("-t", "--text-length", type=int, default=2_000_000)
    p.add_argument("-n", "--pattern-count", type=int, default=50_000)
    p.add_argument("--ranks", default=None,
                   help="comma list of rank counts (default: 1, 2, 4, ... up "
                        "to this host's GPUs; 1,2 on the CPU)")
    p.add_argument("--device", default=None,
                   help="'cpu' runs the ranks on the CPU over gloo")
    def _scaling(a):
        from .scaling import main as scaling_main
        scaling_main(a)
    p.set_defaults(func=_scaling)

    args = parser.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
