"""The join kernel's share of its roofline: a probe on the cell's own table.

The probe hands the kernel ``KEYS`` sorted positions over the uploaded
table of the index's main rank mode (the pair table where the index has
one, else the stream table), each with a symbol to rank, times it with CUDA
events, and holds its ranks equal to :func:`plain_rank`, a frozen copy of
the rank the table's rows encode.

:func:`work_bytes` counts the bytes the work needs, with nothing of the
program's row layout in it: each key 8 B in, its symbol 8 B in and its rank
8 B out; for each distinct 128-position block the keys touch, that block's
symbols at ``ceil(log2 sigma)`` bits each; and one 4-byte count per (block,
symbol) asked.  The least time is those bytes over the card's memory rate
(``peaks.json``).
"""
from __future__ import annotations

import json
import os

import torch

KEYS = 1 << 21
BLOCK = 128
# the card spins this many cycles (a few ms) before each timed run of
# launches, so every launch is queued before the first one runs and the
# events time the device, not the host's launch rate
HEAD_START_CYCLES = 6_000_000
LAUNCHES = 20
M32 = 0xFFFFFFFF


def bits_per_symbol(sigma: int) -> int:
    return max(1, (sigma - 1).bit_length())


def work_bytes(keys: torch.Tensor, syms: torch.Tensor, sigma: int) -> int:
    """Bytes a rank over ``keys`` (int64 positions) of ``syms`` needs, each
    read or written once."""
    n = int(keys.shape[0])
    blocks = keys // BLOCK
    distinct_blocks = int(torch.unique(blocks).numel())
    asked = int(torch.unique(blocks * 64 + syms).numel())
    block_bytes = -(-BLOCK * bits_per_symbol(sigma) // 8)
    return 3 * 8 * n + distinct_blocks * block_bytes + 4 * asked


# -- frozen copy of the rank a stream-layout table encodes ------------------
# A row per 128 positions: ``sigma`` checkpoint words (the count of each
# symbol before the block), zero words up to ``plane_offset``, then
# ``bits_per_symbol`` planes of 4 MSB-first 32-bit lanes.

def plane_offset(sigma: int) -> int:
    off = -(-sigma // 4) * 4
    if (off + bits_per_symbol(sigma) * 4) % 16 == 12:
        off += 4
    return off


def row_words(sigma: int) -> int:
    return plane_offset(sigma) + bits_per_symbol(sigma) * 4


def _popcount(x: torch.Tensor) -> torch.Tensor:
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def plain_rank(table: torch.Tensor, keys: torch.Tensor, syms: torch.Tensor,
               sigma: int) -> torch.Tensor:
    """Occurrences of ``syms[i]`` before position ``keys[i]`` (int64)."""
    P = bits_per_symbol(sigma)
    off = plane_offset(sigma)
    rows = table[keys // BLOCK].long() & M32
    rem = keys % BLOCK
    planes = rows[:, off:off + 4 * P].reshape(-1, P, 4)
    bit = (syms[:, None] >> torch.arange(P, device=keys.device)) & 1
    sel = torch.where(bit[:, :, None] == 1, planes, planes ^ M32)
    match = sel[:, 0]
    for p in range(1, P):
        match = match & sel[:, p]
    take = (rem[:, None] - torch.arange(4, device=keys.device) * 32).clamp(0, 32)
    mask = ((torch.ones_like(take) << take) - 1) << (32 - take)
    return rows.gather(1, syms[:, None])[:, 0] + _popcount(match & mask).sum(1)


def peak_bytes_per_s(run) -> float | None:
    """The card's memory rate from ``peaks.json``, by the name torch gives
    the card; None on the CPU or for a card the table lacks."""
    if run.device.type != "cuda":
        return None
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")) as f:
        peaks = json.load(f)
    got = peaks.get(torch.cuda.get_device_name(run.device))
    return float(got["hbm_bytes_per_s"]) if got else None


def main_table(dev):
    """(table, sigma) of the index's main rank mode."""
    if dev.pair_tbl is not None:
        return dev.pair_tbl, dev.meta.sigma ** 2
    return dev.stream_tbl, dev.meta.sigma


def measure(dev, text_len: int, gen: torch.Generator, hbm_bytes_per_s: float):
    """{'ms', 'bound_ms', 'bytes', 'share_pct'} of the kernel on ``KEYS``
    keys, or None where the table is not the layout :func:`plain_rank`
    reads or the kernel's ranks differ from it."""
    from sview_fmindex_tpu_torch.ops import stream_join

    table, sigma = main_table(dev)
    if table is None or table.dim() != 2 or table.shape[1] != row_words(sigma):
        return None
    device = table.device
    keys = torch.sort(torch.randint(0, text_len + 1, (KEYS,), generator=gen,
                                    device=device))[0]
    syms = torch.randint(0, sigma, (KEYS,), generator=gen, device=device)
    keys = keys.clamp(max=table.shape[0] * BLOCK - 1)
    rank, _ = stream_join.join(table, keys, syms, sigma, False)
    if not torch.equal(rank, plain_rank(table, keys, syms, sigma)):
        return None
    times = []
    for _ in range(2):
        stream_join.join(table, keys, syms, sigma, False)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HEAD_START_CYCLES)
        start.record()
        for _ in range(LAUNCHES):
            stream_join.join(table, keys, syms, sigma, False)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / LAUNCHES)
    nbytes = work_bytes(keys, syms, sigma)
    bound_ms = nbytes / hbm_bytes_per_s * 1e3
    ms = min(times)
    return dict(ms=ms, bound_ms=bound_ms, bytes=nbytes, sigma=sigma,
                share_pct=100.0 * bound_ms / ms)
