"""What bounds the join kernel's row fetch on a table that misses L2:
``python -m sview_fmindex_tpu_torch.bench.join_probe``.

Needs one GPU and ``nvcc``.  Builds ``csrc/join_probe.cu`` and
``csrc/join.cu`` and prints, for ``--keys`` sorted keys (default 2^21, one
B=1M search pass) on seeded synthetic tables, times from CUDA events over
``--reps`` back-to-back launches:

1. the streaming floor: key and payload read, one result written, no row
   touched; with and without the streaming hints;
2. a bare row fetch (the row xored into one word) at row strides of 48, 64,
   112 and 128 bytes, one thread per row against 4 or 8 lanes per row, on
   2^25 + 2^20 rows (48 to 128 bytes apart) and on 2^23 rows of 128 bytes;
3. the thread-per-key kernel the join had before its warp-cooperative
   fetch, with 1, 2 and 4 keys per thread;
4. that kernel (on its own row layout, without the 64-byte padding) and the
   join kernel in turns (old, new, new, old), exactly equal, at every shape
   the port's smoke run times: the two segmented cases on 2^25 + 2^20 rows,
   sigma 16 and sigma 4 on 2^23 rows (the tables of a 1 Gbp index), sigma 5,
   12, 20, 25 and 63 on tables that miss L2 too, and each alphabet on 781,251
   rows (a 1e8-symbol index), whose sigma-4 table fits L2.

The card's name and power limit are printed first.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess

import torch

from sview_fmindex_tpu_torch import kernels
from sview_fmindex_tpu_torch.ops import stream_join as sj

SEG_ROWS = (1 << 25) + (1 << 20)  # 3 segments of 2^24 rows
HBM_ROWS = 1 << 23  # a 1 Gbp index: 2^30 positions / 128
L2_ROWS = 781_251  # a 1e8-symbol index
# (name, sigma, rows, decode, segmented)
SHAPES = [
    ("rank_seg", 4, SEG_ROWS, False, True),
    ("decode_seg", 4, SEG_ROWS, True, True),
    ("rank_hbm", 16, HBM_ROWS, False, False),
    ("decode_hbm", 4, HBM_ROWS, True, False),
    ("rank_hbm sigma 12", 12, HBM_ROWS, False, False),
    ("decode_hbm sigma 12", 12, HBM_ROWS, True, False),
    ("rank_hbm sigma 5", 5, HBM_ROWS, False, False),
    ("decode_hbm sigma 5", 5, HBM_ROWS, True, False),
    ("rank_hbm sigma 20", 20, HBM_ROWS, False, False),
    ("decode_hbm sigma 20", 20, HBM_ROWS, True, False),
    ("rank_hbm sigma 25", 25, HBM_ROWS, False, False),
    ("rank_hbm sigma 63", 63, 1 << 21, False, False),
    ("decode_hbm sigma 63", 63, 1 << 21, True, False),
    ("rank 16", 16, L2_ROWS, False, False),
    ("decode 4", 4, L2_ROWS, True, False),
    ("rank 4", 4, L2_ROWS, False, False),
    ("rank 20", 20, L2_ROWS, False, False),
    ("decode 20", 20, L2_ROWS, True, False),
    ("rank_seg 20", 20, L2_ROWS, False, True),
    ("decode_seg 20", 20, L2_ROWS, True, True),
    ("rank 5", 5, L2_ROWS, False, False),
    ("decode 5", 5, L2_ROWS, True, False),
    ("rank 25", 25, L2_ROWS, False, False),
]
PTR = ctypes.c_void_p


def probe_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(kernels.build("join_probe"))
    lib.probe_stream.argtypes = [PTR, PTR, PTR, ctypes.c_int64, ctypes.c_int, PTR]
    lib.probe_fetch.argtypes = [PTR, ctypes.c_int64, ctypes.c_int, ctypes.c_int, PTR, PTR,
                                ctypes.c_int64, PTR]
    lib.probe_base.argtypes = [ctypes.c_int, ctypes.c_int, PTR, ctypes.c_int64, PTR, PTR, PTR,
                               ctypes.c_int, PTR, PTR, ctypes.c_int64, ctypes.c_int, PTR]
    for fn in (lib.probe_stream, lib.probe_fetch, lib.probe_base):
        fn.restype = ctypes.c_int
    return lib


def launched(err: int) -> None:
    if err:
        raise RuntimeError(f"probe kernel launch failed: {kernels.cuda_error(err)}")


def stream_ptr() -> PTR:
    return PTR(torch.cuda.current_stream().cuda_stream)


def ms_of(fn, reps: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(3_000_000)  # the host queues every launch while the card spins
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(fn_a, fn_b, reps: int) -> tuple[list[float], list[float]]:
    """Times of a, b, b, a: ([a first, a last], [b first, b last])."""
    a1, b1, b2, a2 = (ms_of(f, reps) for f in (fn_a, fn_b, fn_b, fn_a))
    return [a1, a2], [b1, b2]


def sorted_keys(g, n_keys: int, rows: int) -> torch.Tensor:
    """Sorted keys uniform over [0, rows * 128], the first key of the table,
    its last and the one beyond it included."""
    end = rows * sj.SBL
    special = torch.tensor([0, end - 1, end], device="cuda")
    keys = torch.cat([special, torch.randint(0, end + 1, (n_keys - 3,), generator=g,
                                             device="cuda")])
    return torch.sort(keys)[0]


def base_rows(ckpt: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """The row layout of the thread-per-key kernel: planes at sigma rounded
    up to 4 words, no 64-byte padding."""
    pad = -ckpt.shape[1] % 4
    parts = [ckpt, ckpt.new_zeros(ckpt.shape[0], pad), planes] if pad else [ckpt, planes]
    return torch.cat(parts, dim=1).contiguous()


def floor_probe(lib, g, n_keys: int, reps: int) -> None:
    key = torch.randint(0, 2**40, (n_keys,), generator=g, device="cuda")
    payload = torch.randint(0, 64, (n_keys,), generator=g, device="cuda")
    out = torch.empty_like(key)
    args = (key.data_ptr(), payload.data_ptr(), out.data_ptr(), n_keys)
    plain, hinted = in_turns(lambda: launched(lib.probe_stream(*args, 0, stream_ptr())),
                             lambda: launched(lib.probe_stream(*args, 1, stream_ptr())), reps)
    torch.cuda.synchronize()
    assert torch.equal(out, key ^ payload)
    print(f"[floor] {n_keys} keys, 24 B each: default caching {plain[0]:.4f}/{plain[1]:.4f} ms, "
          f"streaming hints {hinted[0]:.4f}/{hinted[1]:.4f} ms "
          f"({24 * n_keys / min(hinted) / 1e9:.3f} TB/s)", flush=True)


def fetch_probe(lib, g, n_keys: int, reps: int) -> None:
    words = torch.randint(0, 2**31 - 1, (SEG_ROWS * 128 // 4,), generator=g, device="cuda",
                          dtype=torch.int32)
    out = torch.empty(n_keys, dtype=torch.int64, device="cuda")
    for rows, cases in (
            (SEG_ROWS, [(48, 3), (64, 2), (64, 3), (64, 4), (112, 7), (128, 7), (128, 4),
                        (128, 8)]),
            (HBM_ROWS, [(128, 4), (128, 8)])):
        key = sorted_keys(g, n_keys, rows - 1)
        distinct = int(torch.unique(key >> sj.SBL_SHIFT).numel())
        for stride, vecs in cases:
            times = []
            for lanes in (1, 4, 8):
                def fn(lanes=lanes):
                    launched(lib.probe_fetch(words.data_ptr(), stride // 16, vecs, lanes,
                                             key.data_ptr(), out.data_ptr(), n_keys,
                                             stream_ptr()))
                times.append(f"{lanes} lane{'s' if lanes > 1 else ''} per row "
                             f"{ms_of(fn, reps):.4f} ms")
            print(f"[fetch] {rows} rows {stride} B apart ({rows * stride / 2**30:.2f} GiB), "
                  f"{16 * vecs} B of each, {distinct} distinct rows of {n_keys} keys: "
                  + ", ".join(times), flush=True)
    torch.cuda.synchronize()


def join_caller(lib_fn, table, keys, payload, sigma, decode, seg_base, extra=()):
    """A closure that launches ``lib_fn`` (sview_join's arguments, then
    ``extra``) and its outputs."""
    n = keys.shape[0]
    rank = torch.empty(n, dtype=torch.int64, device="cuda")
    sym = torch.empty(n, dtype=torch.int64, device="cuda") if decode else None
    args = (sigma, int(decode), table.data_ptr(), table.shape[0], keys.data_ptr(),
            None if decode else payload.data_ptr(),
            None if seg_base is None else seg_base.data_ptr(), sj._seg_shift(),
            rank.data_ptr(), None if sym is None else sym.data_ptr(), n)
    return (lambda: launched(lib_fn(*args, *extra, stream_ptr()))), rank, sym


def join_probe(lib, g, n_keys: int, reps: int) -> None:
    for name, sigma, rows, decode, segmented in SHAPES:
        planes = torch.randint(-2**31, 2**31, (rows, sj._planes_for(sigma) * sj.LANES),
                               generator=g, device="cuda").to(torch.int32)
        ckpt = torch.randint(0, 2**31, (rows, sigma), generator=g, device="cuda").to(torch.int32)
        old_tbl, new_tbl = base_rows(ckpt, planes), sj._rows(ckpt, planes)
        del planes, ckpt
        keys = sorted_keys(g, n_keys, rows)
        payload = None if decode else torch.randint(0, sigma, (n_keys,), generator=g,
                                                    device="cuda")
        seg_base = None
        if segmented:
            seg_base = torch.randint(0, 2**35, (-(-rows // sj.SEG_BLOCKS), sigma), generator=g,
                                     device="cuda")
        old, old_rank, old_sym = join_caller(lib.probe_base, old_tbl, keys, payload, sigma,
                                             decode, seg_base, (1,))
        new, new_rank, new_sym = join_caller(kernels.join_lib().sview_join, new_tbl, keys,
                                             payload, sigma, decode, seg_base)
        t_old, t_new = in_turns(old, new, reps)
        want_rank, want_sym = sj.join_plain(new_tbl, keys, payload, sigma, decode, seg_base)
        torch.cuda.synchronize()
        assert torch.equal(new_rank, want_rank) and torch.equal(old_rank, want_rank), name
        assert not decode or (torch.equal(new_sym, want_sym) and torch.equal(old_sym, want_sym))
        line = (f"[join] {name}: sigma {sigma}, {rows} rows of {old_tbl.shape[1] * 4} B "
                f"(thread per key) / {new_tbl.shape[1] * 4} B (join kernel), "
                f"{int(torch.unique(keys >> sj.SBL_SHIFT).numel())} distinct rows: exact; "
                f"thread per key {t_old[0]:.4f}/{t_old[1]:.4f} ms, "
                f"join kernel {t_new[0]:.4f}/{t_new[1]:.4f} ms")
        if sigma in (4, 16) and rows > L2_ROWS:
            kpt = []
            for k in (2, 4):
                fn, rank_k, _ = join_caller(lib.probe_base, old_tbl, keys, payload, sigma,
                                            decode, seg_base, (k,))
                kpt.append(f"{k} keys per thread {ms_of(fn, reps):.4f} ms")
                torch.cuda.synchronize()
                assert torch.equal(rank_k, want_rank), (name, k)
            line += "; thread per key with " + ", ".join(kpt)
        print(line, flush=True)
        del old_tbl, new_tbl
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keys", type=int, default=1 << 21)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this measurement needs a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    lib = probe_lib()
    kernels.join_lib()
    for name in ("join_probe", "join"):
        if name in kernels.BUILD_LOG:
            secs, out = kernels.BUILD_LOG[name]
            spills = [ln for ln in out.splitlines() if re.search(r"[1-9]\d* bytes spill", ln)]
            print(f"[build] {name}.cu in {secs:.1f} s; kernels with spills: {len(spills)}",
                  flush=True)
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    floor_probe(lib, g, args.keys, args.reps)
    fetch_probe(lib, g, args.keys, args.reps)
    join_probe(lib, g, args.keys, args.reps)


if __name__ == "__main__":
    main()
