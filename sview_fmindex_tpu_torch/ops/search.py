"""Batched lockstep backward search (port of ``sview_fmindex_tpu.ops.search``).

A k-mer table seeds every lane's range (``count_array.rs:203-223``, incl.
the short-pattern subtree range), optionally a dense table over all
``sigma**dense_k`` strings seeds the last ``dense_k`` symbols in one gather,
then every lane advances one LF step per iteration with done-masks.  Three
engines rank the range ends:

- gather: one fused-table row gather per end (``ops.rank``); on a CUDA
  device the whole search, seed and steps, is one launch of the kernel
  ``csrc/gather_search.cu`` (:func:`gather_ranges_cuda`), and
  :func:`gather_ranges` is its plain version, the CPU's path,
- stream: sort-join passes over the sigma stream table (``ops.stream_join``),
- pair stream: sort-join passes over the sigma^2 pair table
  (``build/pair_table.py``), two pattern symbols per pass.  Uniform-length
  batches stay in sorted order across passes (``_ranges_chain``).
"""
from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from .. import tracing
from . import stream_join as sj
from .rank import rank_next, u32

# launches of the gather engine's kernel ("gather"), counted where it is
# launched, so a run can show its gather engine went through it
LAUNCHES: collections.Counter = collections.Counter()


def encode_patterns(enc_table: torch.Tensor, patterns: torch.Tensor) -> torch.Tensor:
    """raw pattern bytes uint8 [B, L] -> symbol indices int64 [B, L]
    (a 256-entry table gather; the table is the identity for PassThrough)."""
    return enc_table[patterns.long()]


def blob_initial_range(meta, kmer_tbl: torch.Tensor, sym: torch.Tensor,
                       lens: torch.Tensor):
    """Blob k-mer LUT seeding.  sym int64 [B, L], lens int64 [B].

    Returns (lo, hi) int64 [B] and rem_steps int64 [B] (LF steps left).
    """
    k = meta.kmer_size
    base = meta.sigma + 1
    Lmax = sym.shape[-1]
    m = lens.clamp(max=k)
    start = torch.zeros_like(lens)
    for i in range(k):
        j = (lens - m + i).clamp(0, max(Lmax - 1, 0))
        digit = sym.gather(1, j[:, None])[:, 0] + 1
        start = start + torch.where(i < m, digit * base ** (k - 1 - i), 0)
    # gap covers the unsearched low digits for short patterns
    # (count_array.rs:209-215); 0 when len >= k.
    gap = base ** (k - m) - 1
    lo = kmer_tbl[start - 1]
    hi = kmer_tbl[start + gap]
    return lo, hi, (lens - k).clamp(min=0)


def _dense_index(meta, sym: torch.Tensor, lens: torch.Tensor, fixed_len):
    """Big-endian base-sigma index of each lane's last dense_k symbols."""
    dk = meta.dense_k
    idx = torch.zeros_like(lens)
    for i in range(dk):
        if fixed_len is not None:
            digit = sym[:, fixed_len - dk + i]
        else:
            j = (lens - dk + i).clamp(0, max(sym.shape[-1] - 1, 0))
            digit = sym.gather(1, j[:, None])[:, 0]
        idx = idx * meta.sigma + digit
    return idx


def initial_range(meta, kmer_tbl, dense_lo, dense_hi, sym, lens,
                  all_dense: bool = False, fixed_len: int | None = None):
    """Seed every lane: dense table when len >= dense_k, blob table else.

    Returns (lo, hi) int64 [B], rem_steps int64 [B], seed_len int64 [B].
    ``all_dense``: every lane's length >= dense_k (the blob seed is skipped);
    ``fixed_len``: all lanes share this length (digits by static slicing).
    """
    if all_dense and meta.dense_k:
        idx = _dense_index(meta, sym, lens, fixed_len)
        return (u32(dense_lo[idx]), u32(dense_hi[idx]), lens - meta.dense_k,
                torch.full_like(lens, meta.dense_k))
    lo, hi, rem = blob_initial_range(meta, kmer_tbl, sym, lens)
    seed_len = torch.full_like(lens, meta.kmer_size)
    if meta.dense_k:
        dk = meta.dense_k
        use = lens >= dk
        idx = torch.where(use, _dense_index(meta, sym, lens, None), 0)
        lo = torch.where(use, u32(dense_lo[idx]), lo)
        hi = torch.where(use, u32(dense_hi[idx]), hi)
        rem = torch.where(use, lens - dk, rem)
        seed_len = torch.where(use, dk, seed_len)
    return lo, hi, rem, seed_len


def batch_facts(meta, lens, B: int, Lmax: int) -> tuple:
    """Host facts of a [B, Lmax] batch: ``(steps, all_dense, fixed_len)``,
    the LF-loop trip count (the most steps any lane needs), whether every
    lane is long enough for the dense seed, and the one length all lanes
    share (else None).

    ``lens`` None: every lane has length ``Lmax``, and the facts follow from
    the shape alone.  Else ``lens`` (host lengths; ``B`` is then its size)
    is read by one min and one max; only a batch straddling ``dense_k``
    whose short lanes could need more steps than its long ones takes a
    third, masked max."""
    k, dk = meta.kmer_size, meta.dense_k

    def steps_of(n):   # steps of a lane of length n
        return n - dk if dk and n >= dk else max(n - k, 0)

    if lens is None:
        if B == 0:
            return 0, False, None
        lmin = lmax = Lmax
    else:
        lens = np.asarray(lens)
        if lens.size == 0:
            return 0, False, None
        lmin, lmax = int(lens.min()), int(lens.max())
    most = steps_of(lmax)
    if dk and lmin < dk <= lmax and most < dk - 1 - k:
        # the long lanes' most is lmax - dk; a short lane may need up to
        # dk - 1 - k.  Long lanes read 0 here, which needs no steps
        # (numpy's ``max(where=)`` takes ten times as long)
        most = max(most, steps_of(int((lens * (lens < dk)).max())))
    return (min(most, max(Lmax - k, 0)), bool(dk) and lmin >= dk,
            lmin if lmin == lmax else None)


def sym_back(sym: torch.Tensor, lens: torch.Tensor, seed_len: torch.Tensor, back):
    """Symbol ``back`` steps from the seed (back=0 is the first LF symbol);
    ``back`` is an int or a per-lane tensor.  The clamp keeps finished
    lanes in range."""
    j = (lens - seed_len - 1 - back).clamp(0, sym.shape[-1] - 1)
    return sym.gather(1, j[:, None])[:, 0]


def lf_step(pre_tbl: torch.Tensor, rank, s: torch.Tensor, lo: torch.Tensor,
            hi: torch.Tensor, active: torch.Tensor):
    """One LF step with code ``s`` of every active lane's [lo, hi):
    ``pre_tbl[s] + rank(ends, codes)`` over the 2B range ends.  Inactive
    lanes rank position 0 (a hot row) instead of a random one."""
    B = lo.shape[0]
    ends_q = torch.where(active, torch.stack([lo, hi]), 0).reshape(2 * B)
    ranks = rank(ends_q, torch.cat([s, s]))
    pre = pre_tbl[s]
    return (torch.where(active, pre + ranks[:B], lo),
            torch.where(active, pre + ranks[B:], hi))


def _step_loop(dev, rank1, sym, lens, lo, hi, rem_steps, seed_len, steps: int):
    """``steps`` single-symbol LF steps of every lane still active."""
    for t in range(steps):
        lo, hi = lf_step(dev.count_arr, rank1, sym_back(sym, lens, seed_len, t), lo, hi,
                         (t < rem_steps) & (lo < hi))
    return lo, hi


def gather_ranges(dev, sym: torch.Tensor, lens: torch.Tensor, steps: int,
                  all_dense: bool = False, fixed_len: int | None = None):
    """The gather engine in plain PyTorch: seed, then ``steps`` LF steps,
    each one fused-row gather per range end (``ops.rank.rank_next``).  The
    CPU's path, and the plain version of :func:`gather_ranges_cuda`."""
    meta = dev.meta
    lo, hi, rem_steps, seed_len = initial_range(
        meta, dev.kmer_tbl, dev.dense_lo, dev.dense_hi, sym, lens,
        all_dense=all_dense, fixed_len=fixed_len)

    def rank1(pos, s):
        return rank_next(meta, dev.fused, dev.sentinel, pos, s)

    return _step_loop(dev, rank1, sym, lens, lo, hi, rem_steps, seed_len, steps)


def check_kernel_tables(kernel: str, meta, fused: torch.Tensor, tables) -> None:
    """Raise ValueError unless ``meta`` is a narrow index of 1-6 planes of
    1, 2 or 4 lanes, ``fused`` its contiguous int32 [n, sigma + planes *
    lanes] table, and each of ``tables`` (name, tensor, dtype, dimensions)
    a contiguous tensor of that dtype on ``fused``'s device: the layout the
    port's CUDA kernels over the fused table read (``kernel`` names the one
    asking)."""
    if meta.wide_pos or not 1 <= meta.num_planes <= 6 or meta.num_lanes not in (1, 2, 4) \
            or meta.block_len != 32 * meta.num_lanes:
        raise ValueError(f"the {kernel} kernel serves narrow indexes of 1-6 planes of "
                         f"1, 2 or 4 lanes, got {meta}")
    device = fused.device
    for name, t, dtype, dim in [("fused", fused, torch.int32, 2), *tables]:
        if t is None or t.device != device or t.dtype != dtype or t.dim() != dim \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of {dim} dimension(s) "
                             f"on {device}")
    width = meta.sigma + meta.num_planes * meta.num_lanes
    if fused.shape[1] != width:
        raise ValueError(f"fused must be [n, {width}], got {list(fused.shape)}")


def check_gather_tables(dev) -> None:
    """Raise ValueError unless ``dev`` is an index the gather search kernel
    takes (:func:`check_kernel_tables`, with its k-mer, count and dense
    tables).  Run once, by ``DeviceFmIndex.from_host`` on a card;
    :func:`gather_ranges_cuda` then checks only the batch."""
    tables = [("kmer_tbl", dev.kmer_tbl, torch.int64, 1),
              ("count_arr", dev.count_arr, torch.int64, 1)]
    if dev.meta.dense_k:
        tables += [("dense_lo", dev.dense_lo, torch.int32, 1),
                   ("dense_hi", dev.dense_hi, torch.int32, 1)]
    check_kernel_tables("gather search", dev.meta, dev.fused, tables)


def gather_ranges_cuda(dev, sym: torch.Tensor, lens: torch.Tensor, steps: int):
    """:func:`gather_ranges` in one launch of ``csrc/gather_search.cu``:
    (lo, hi) int64 [B], equal to it bit for bit, on an index that
    :func:`check_gather_tables` passed.  The batch is checked before the
    kernel's library is loaded; the kernel runs on the current stream and
    is not waited for.  Each launch is counted in ``LAUNCHES["gather"]``
    and, while a profiler records, as ``gather_kernel``."""
    from .. import kernels

    meta = dev.meta
    device = sym.device
    if not sym.is_cuda:
        raise ValueError(f"the gather search kernel runs on a CUDA device, sym is on {device}")
    if sym.dtype != torch.int64 or sym.dim() != 2 or not sym.is_contiguous():
        raise ValueError(f"sym must be a contiguous int64 [B, L] tensor, got {sym.dtype} "
                         f"{list(sym.shape)}{'' if sym.is_contiguous() else ', not contiguous'}")
    B, L = sym.shape
    if (lens.dtype != torch.int64 or lens.shape != (B,) or lens.device != device
            or not lens.is_contiguous()):
        raise ValueError(f"lens must be a contiguous int64 [{B}] tensor on {device}, got "
                         f"{lens.dtype} {list(lens.shape)} on {lens.device}")
    if dev.fused.device != device:
        raise ValueError(f"the index is on {dev.fused.device}, the batch on {device}")
    lo = torch.empty(B, dtype=torch.int64, device=device)
    hi = torch.empty(B, dtype=torch.int64, device=device)
    if B == 0:
        return lo, hi
    if L == 0:
        raise ValueError("patterns of a batch of B > 0 lanes need at least one column")
    lib = kernels.gather_search_lib()
    dense = (dev.dense_lo.data_ptr(), dev.dense_hi.data_ptr()) if meta.dense_k else (None, None)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.sview_gather_search(
            meta.num_planes, meta.num_lanes, meta.sigma, dev.fused.data_ptr(),
            dev.fused.shape[1], dev.kmer_tbl.data_ptr(), dev.kmer_tbl.shape[0], *dense,
            meta.dense_k, meta.kmer_size, dev.count_arr.data_ptr(), dev.sentinel,
            sym.data_ptr(), lens.data_ptr(), B, L, steps, lo.data_ptr(), hi.data_ptr(),
            ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"gather search kernel launch failed: {kernels.cuda_error(err)}")
    LAUNCHES["gather"] += 1
    tracing.count("gather_kernel")
    return lo, hi


def pos_ranges(dev, sym: torch.Tensor, lens: torch.Tensor, steps: int,
               use_stream: bool = False, use_pair: bool = True,
               all_dense: bool = False, fixed_len: int | None = None):
    """Full backward search: (lo, hi) int64 [B] for every pattern lane of
    ``dev`` (a ``DeviceFmIndex``).

    ``steps`` must be >= every lane's rem_steps (see ``batch_facts``).
    ``use_stream`` ranks through sort-join passes instead of row gathers;
    with the pair table resident (``meta.pair_rows``) and ``use_pair``,
    each pass consumes two pattern symbols.  Without it, a CUDA index runs
    the gather engine's kernel.
    """
    if not use_stream and dev.fused.is_cuda:
        return gather_ranges_cuda(dev, sym, lens, steps)
    if not use_stream:
        return gather_ranges(dev, sym, lens, steps, all_dense, fixed_len)
    meta = dev.meta
    sentinel = dev.sentinel
    lo, hi, rem_steps, seed_len = initial_range(
        meta, dev.kmer_tbl, dev.dense_lo, dev.dense_hi, sym, lens,
        all_dense=all_dense, fixed_len=fixed_len)
    if steps == 0:
        return lo, hi
    sigma = meta.sigma

    def sym_at(back):
        return sym_back(sym, lens, seed_len, back)

    def rank1(pos, s):
        return sj.rank_next_sorted(dev.stream_tbl, sentinel, pos, s, sigma)

    use_pair_stream = use_pair and meta.pair_rows > 0 and steps >= 2
    if use_pair_stream and fixed_len is not None and (all_dense or not meta.dense_k):
        # uniform length and seed: every lane takes exactly ``steps`` steps
        return _ranges_chain(dev, lo, hi, sym, fixed_len, steps)

    if not use_pair_stream:
        return _step_loop(dev, rank1, sym, lens, lo, hi, rem_steps, seed_len, steps)

    sigma2 = sigma * sigma
    j_star, c_star = dev.pair_fix[0], dev.pair_fix[1]

    def pair_rank(pos, c):
        # one table entry's LF target is the sentinel row; its code is a
        # stand-in and must not be counted (build/pair_table.py)
        pq = pos + (pos < sentinel).long()
        return (sj.rank_next_sorted(dev.pair_tbl, sentinel, pos, c, sigma2)
                - ((c == c_star) & (pq > j_star)).long())

    for t in range(steps // 2):
        # a lane takes a pair step while >= 2 of its LF steps remain
        code = sym_at(2 * t) * sigma + sym_at(2 * t + 1)
        lo, hi = lf_step(dev.pair_c2, pair_rank, code, lo, hi,
                         (2 * t + 1 < rem_steps) & (lo < hi))
    # lanes with an odd number of LF steps have exactly one left, at their
    # final (leftmost) symbol
    return lf_step(dev.count_arr, rank1, sym_at(rem_steps - 1), lo, hi,
                   (rem_steps % 2 == 1) & (lo < hi))


def sorted_pass(pos: torch.Tensor, lane: torch.Tensor, codes: torch.Tensor,
                table: torch.Tensor, sigma: int, sentinel,
                seg_base: torch.Tensor | None = None):
    """One pass of a sorted chain: sort the 2B positions by their
    sentinel-shifted key, carry each lane's original index through the
    permutation, and rank each lane's code (``codes[lane % B]``) in one join.
    Returns (key, lane, code, rank) in sorted order."""
    key, perm = torch.sort(pos + (pos < sentinel).long())
    lane = lane[perm]
    c = codes[lane % codes.shape[0]]
    ranks, _ = sj.join(table, key, c, sigma, False, seg_base)
    return key, lane, c, ranks


def unsort(pos: torch.Tensor, lane: torch.Tensor, B: int):
    """A sorted chain's final positions back to lane order: (lo, hi)."""
    out = torch.empty_like(pos)
    out[lane] = pos
    return out[:B], out[B:]


def _ranges_chain(dev, lo, hi, sym, fixed_len: int, steps: int):
    """Backward search staying in SORTED order across pair passes.

    Each pass sorts the 2B range ends once and carries each lane's original
    index through the permutation; its codes are gathered by that index, so
    no unsort is needed until the end (passes + 1 permutations instead of
    2 per pass).  Requires uniform pattern and seed length: every lane takes
    exactly ``steps`` LF steps.

    - Empty ranges (lo == hi) need no masks: ranking equal ends with the
      same code gives equal results.
    - Positions ride UNSHIFTED; the sentinel +1 shift (``bwm/mod.rs:202-204``)
      is applied to each pass's key (the shift map is not injective, so it
      is never carried).
    """
    meta = dev.meta
    sentinel = dev.sentinel
    B = lo.shape[0]
    sigma = meta.sigma
    seed = meta.dense_k if meta.dense_k else meta.kmer_size
    j0 = fixed_len - seed - 1
    j_star, c_star = dev.pair_fix[0], dev.pair_fix[1]

    pos = torch.cat([lo, hi])
    lane = torch.arange(2 * B, device=pos.device)
    for t in range(steps // 2):
        code = sym[:, j0 - 2 * t] * sigma + sym[:, j0 - 2 * t - 1]
        key, lane, c, ranks = sorted_pass(pos, lane, code, dev.pair_tbl,
                                          sigma * sigma, sentinel)
        pos = dev.pair_c2[c] + ranks - ((c == c_star) & (key > j_star)).long()
    if steps % 2:
        _, lane, c, ranks = sorted_pass(pos, lane, sym[:, j0 - (steps - 1)],
                                        dev.stream_tbl, sigma, sentinel)
        pos = dev.count_arr[c] + ranks
    return unsort(pos, lane, B)
