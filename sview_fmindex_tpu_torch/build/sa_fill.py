"""Fill the full (r=1) suffix array on the device from a subsampled slice
(port of ``sview_fmindex_tpu.build.sa_fill``).

Only ``SA[R*i]`` is uploaded; the rest is reconstructed by a forward PUSH
along the LF cycle.  LF maps the row holding SA value v to the row holding
v-1 (``locate/mod.rs:23-25``).  One chain starts at every known row; each
round decodes the BWT symbol at every chain head (``bwm/mod.rs:217-236``)
through the join kernel in decode mode, LF-steps, and writes ``value-1``
into the next row.  A chain stops when it lands on another known row (``row
% R == 0``) or on the sentinel row (value 0, ``locate/mod.rs:27-30``), and
stopped chains are compacted away every round.  Every row is written once:
the chains partition the cycle into the segments between known rows.  So
the chains are pushed a slice of ``_FILL_CHAINS`` at a time, each slice until
its last chain stops, in any order: the live width, and with it the chain
state on the device, is bounded whatever the text's length.

The value-0 -> value-(n-1) wrap segment has no chain entering it; those
rows are finished by a backward PULL: walk LF from each until a filled row
f after k steps, then value = SA[f] + k.
"""
from __future__ import annotations

import torch

from ..ops import stream_join as sj
from ..ops.rank import pre_rank_and_symidx, pre_rank_and_symidx_from_rows, to_i32, u32

UNFILLED = 0xFFFFFFFF  # uint32 pattern of an unfilled row (SA values are < n < 2^32)
_WRAP_BOUND = 1 << 16
# entries per piece of the whole-SA passes: no int64 copy of the SA and no
# single call over more than INT_MAX entries (CUDA's nonzero refuses those)
_PIECE = 1 << 28
# chains pushed at once: the fill's live width
_FILL_CHAINS = 1 << 26
# device bytes a live chain may hold at a round's peak: its int64 lanes (pos,
# val, key, perm, val[perm], rank, sym, nxt: 64), the masks and the radix
# sort's scratch; 98 were measured on an H100 with every chain of a 3.1e9 bp
# index live
CHAIN_BYTES = 128
# the last fill's shape: chains, slices, the widest round, rounds
STATS: dict = {}


def _seed(sa_up: torch.Tensor, n: int, R: int) -> torch.Tensor:
    """Output SA (int32 [n]) with the known rows written, a piece of chains
    at a time, no wider than a slice."""
    # -1 is UNFILLED's int32 bit pattern
    out = torch.full((n,), -1, dtype=torch.int32, device=sa_up.device)
    step = min(_PIECE, _FILL_CHAINS)
    for a in range(0, sa_up.shape[0], step):
        vals = sa_up[a:a + step]
        out[a * R:(a + vals.shape[0]) * R:R] = to_i32(vals)
    return out


def fill_budget(n: int, chains: int) -> int:
    """Device bytes the fill may hold above what was resident before it: the
    int32 output SA and one slice's chain state (a seed piece holds less)."""
    return 4 * n + min(chains, _FILL_CHAINS) * CHAIN_BYTES


def unfilled_rows(out: torch.Tensor) -> torch.Tensor:
    """Rows (int64) of the int32 SA ``out`` that hold UNFILLED: its words
    compared with -1, UNFILLED's bit pattern, a piece at a time."""
    return torch.cat([torch.nonzero(out[a:a + _PIECE] == -1)[:, 0] + a
                      for a in range(0, out.shape[0], _PIECE)]
                     or [torch.zeros(0, dtype=torch.int64, device=out.device)])


def _decode_sorted(meta, fused, stream_tbl, key: torch.Tensor):
    """(rank, sym) at sorted sentinel-shifted keys: the join kernel in
    decode mode over the stream table, or fused-row gathers without one."""
    if stream_tbl is not None:
        return sj.join(stream_tbl, key, None, meta.sigma, True)
    shift = meta.block_len.bit_length() - 1
    return pre_rank_and_symidx_from_rows(meta, fused[key >> shift],
                                         key & (meta.block_len - 1))


def fill_sa_full_device(meta, fused, count_arr, sentinel: int, sa_up: torch.Tensor,
                        n: int, R: int, stream_tbl=None) -> torch.Tensor:
    """int32 [n] tensor holding the full suffix array (uint32 bit patterns).

    ``sa_up``: int64 [m] with ``sa_up[i] == SA[R*i]`` (the blob's sampled SA
    strided down to ratio R); ``R*i < n`` for all i.  Equal to the builder's
    ``sa_full_path`` output.  The chains go a slice of ``_FILL_CHAINS`` at a
    time; ``STATS`` holds the run's shape.
    """
    sa_up = sa_up.long()
    out = _seed(sa_up, n, R)
    m = sa_up.shape[0]
    STATS.clear()
    STATS.update(chains=m, slices=0, live_width=0, rounds=0)
    if n <= 1:
        return out
    for a in range(0, m, _FILL_CHAINS):
        val = sa_up[a:a + _FILL_CHAINS]
        pos = torch.arange(a, a + val.shape[0], device=sa_up.device) * R
        _push(meta, fused, count_arr, sentinel, stream_tbl, out, pos, val, R)
        STATS["slices"] += 1
    return _pull_wrap(meta, fused, count_arr, sentinel, out, limit=64 * R + 1024)


def _push(meta, fused, count_arr, sentinel, stream_tbl, out, pos, val, R: int) -> None:
    """Push the chains headed at rows ``pos`` (holding ``val``) into ``out``
    until every one has stopped."""
    while True:
        # a chain at the sentinel row has written value 0 there and stops;
        # test before the +1 shift, which is not injective
        live = pos != sentinel - 1
        pos, val = pos[live], val[live]
        if not pos.shape[0]:
            return
        key, perm = torch.sort(pos + (pos < sentinel).long())
        val = val[perm] - 1
        STATS["live_width"] = max(STATS["live_width"], key.shape[0])
        STATS["rounds"] += 1
        rank, sym = _decode_sorted(meta, fused, stream_tbl, key)
        nxt = count_arr[sym] + rank
        out[nxt] = to_i32(val)
        cont = nxt % R != 0
        pos, val = nxt[cont], val[cont]


def _pull_wrap(meta, fused, count_arr, sentinel, out, limit: int):
    """Resolve the unfilled wrap-segment rows by walking LF to a filled row."""
    n = out.shape[0]
    rows = unfilled_rows(out)
    if rows.shape[0] >= _WRAP_BOUND:
        raise RuntimeError(
            f"sa fill: {rows.shape[0]} unfilled rows exceed the wrap-"
            "segment bound — push phase incomplete")
    cur = rows
    off = torch.zeros_like(rows)
    res = torch.zeros_like(rows)
    resolved = torch.zeros(rows.shape[0], dtype=torch.bool, device=out.device)
    it = 0
    while it < limit and not bool(resolved.all()):
        # the sentinel row holds SA value 0 (locate/mod.rs:27-30)
        is_sent = (cur == sentinel - 1) & ~resolved
        res = torch.where(is_sent, off, res)
        resolved = resolved | is_sent
        rank, sym, _ = pre_rank_and_symidx(meta, fused, sentinel,
                                           torch.where(resolved, 0, cur))
        nxt = count_arr[sym] + rank
        lv = u32(out[nxt.clamp(max=n - 1)])
        hit = ~resolved & (lv != UNFILLED)
        res = torch.where(hit, lv + off + 1, res)
        resolved = resolved | hit
        cur = torch.where(resolved, cur, nxt)
        off = torch.where(resolved, off, off + 1)
        it += 1
    n_unresolved = int((~resolved).sum())
    if n_unresolved:
        raise RuntimeError(f"sa fill: {n_unresolved} wrap rows failed to resolve")
    out[rows] = to_i32(res)
    return out
