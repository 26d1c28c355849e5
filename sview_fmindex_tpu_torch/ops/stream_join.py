"""Sort-join rank engine (port of ``sview_fmindex_tpu.ops.stream_join``).

Rank queries are sorted by position, answered by one pass of the join
kernel over a row-major stream table, and scattered back to lane order.

Stream table layout: int32 ``[n_blocks, RW]``, one row per ``SBL`` = 128
positions (``n_blocks = text_len // 128 + 1``), ``RW = OFF + P*4``:

- words ``0..sigma``: the block's checkpoint (count of each symbol before
  the block, ``bwm/mod.rs:126-134``),
- words ``sigma..OFF``: zero padding; ``OFF`` (:func:`_plane_off`) is sigma
  rounded up to a multiple of 4, so each row and its planes are 16-byte
  aligned for the kernel's vector copies, plus 4 where the row would
  otherwise be 48 bytes modulo 64 and straddle one 64-byte piece of device
  memory more than it must,
- words ``OFF + p*4 + l``: MSB-first uint32 lane l (positions [32l,
  32l+32)) of bit plane p, ``P = ceil(log2 sigma)``; the planes end the row.

That is 16 words (64 B) per block at sigma=4, 32 words (128 B) at the pair
table's sigma^2=16, 20 (80 B) at sigma=5, 40 (160 B) at sigma=20 and 48
(192 B) at sigma^2=25.  Every sigma up to ``MAX_SIGMA`` = 63 is served, as
in the JAX package.  The JAX package's transposed, tiled TPU layout (no
padding between checkpoints and planes) converts with
:func:`stream_table_from_reference`.

Wide (u64-position) tables keep the same rows with SEGMENT-LOCAL
checkpoints: each counts from the first block of its segment of
``SEG_BLOCKS`` blocks (2^31 positions, so it fits 32 bits), and ``seg_base``
int64 ``[n_segs, sigma]`` holds the global count at each segment start
(:func:`derive_stream_table_wide`).

:func:`join` is the kernel's entry point: on CUDA tensors it launches the
hand-written kernel (``csrc/join.cu``), on CPU tensors it runs
:func:`join_plain`, the plain-torch version of the same function.  Given a
``seg_base`` it runs the segmented modes, which return global ranks.
"""
from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from .rank import _combine_planes, _lane_masks, popcount32, u32

SBL = 128
SBL_SHIFT = 7
LANES = SBL // 32  # u32 lanes per plane per block
# wide-table segment: 2^24 stream blocks = 2^31 positions, so a local
# checkpoint fits 32 bits.  A power of two, read at call time.
SEG_BLOCKS = 1 << 24

# the join kernel's symbol budget: a payload carries the symbol in 6 bits
MAX_SIGMA = 63

# kernel launches per mode ("rank", "decode", "rank_seg", "decode_seg"), and
# per (mode, sigma) in LAUNCHES_BY_SIGMA; counted only where the CUDA kernel
# is launched, so a run can show its main path went through it
LAUNCHES: collections.Counter = collections.Counter()
LAUNCHES_BY_SIGMA: collections.Counter = collections.Counter()


def _planes_for(sigma: int) -> int:
    return max(1, (sigma - 1).bit_length())


def _plane_off(sigma: int) -> int:
    """Word offset of a row's first plane, the one place that decides the
    row layout (``plane_offset`` in ``csrc/join.cu`` states the same rule):
    sigma rounded up to 4 words, and 4 words more where the row would
    otherwise be 48 bytes modulo 64.  Device memory comes in aligned 64-byte
    pieces; such a row would straddle one more piece than it must at two of
    every four positions, the padded row never does."""
    off = -(-sigma // 4) * 4
    if (off + _planes_for(sigma) * LANES) % 16 == 12:
        off += 4
    return off


def _rw(sigma: int) -> int:
    """Words per stream-table row."""
    return _plane_off(sigma) + _planes_for(sigma) * LANES


def _rows(ckpt: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """Stream-layout rows from checkpoint words [n, sigma] and plane lanes
    [n, P*4]: the zero padding goes between them."""
    pad = _plane_off(ckpt.shape[1]) - ckpt.shape[1]
    parts = [ckpt, ckpt.new_zeros(ckpt.shape[0], pad), planes] if pad else [ckpt, planes]
    return torch.cat(parts, dim=1).contiguous()


def stream_rows(text_len: int) -> int:
    """Rows of a stream table: one per 128 positions of [0, text_len]."""
    return text_len // SBL + 1


def _regroup(meta, fused: torch.Tensor, text_len: int, ckpt_words: int):
    """Per stream block: the leading ``ckpt_words`` words of its first fused
    block, and its plane lanes (int32 [n_blocks, P*4]) taken from the
    ``128 // BL`` fused blocks it covers."""
    g = SBL // meta.block_len  # fused blocks per stream block
    P = _planes_for(meta.sigma)
    fl = meta.num_lanes
    n_s = stream_rows(text_len)
    need = n_s * g
    f = fused
    if f.shape[0] < need:
        f = torch.cat([f, f.new_zeros(need - f.shape[0], f.shape[1])])
    f = f[:need].reshape(n_s, g, f.shape[1])
    planes = (f[:, :, ckpt_words:ckpt_words + P * fl].reshape(n_s, g, P, fl)
              .permute(0, 2, 1, 3).reshape(n_s, P * LANES))
    return f[:, 0, :ckpt_words], planes


def derive_stream_table(meta, fused: torch.Tensor, text_len: int) -> torch.Tensor:
    """Stream table (int32 [n_blocks, RW]) from the fused gather table.

    Both tables carry the same information at different granularity: a
    stream block's checkpoint IS the fused checkpoint of fused block
    ``(128 // BL) * b``, and its plane lanes are the fused lanes of the
    ``128 // BL`` fused blocks it covers.  Stream planes are the low
    ``_planes_for(sigma)`` fused planes.
    """
    return _rows(*_regroup(meta, fused, text_len, meta.sigma))


def derive_stream_table_wide(meta, fused: torch.Tensor, text_len: int):
    """Segment-local stream table (int32 [n_blocks, RW]) and ``seg_base``
    (int64 [n_segs, sigma]) from the wide fused table (int32 [n_fused,
    2*sigma + planes*lanes]: checkpoint hi words, lo words, plane lanes).

    ``seg_base[s]`` is the global checkpoint of block ``s * SEG_BLOCKS``; a
    row's checkpoint word is its global checkpoint minus its segment's base,
    a count over fewer than 2^31 positions.
    """
    sigma = meta.sigma
    ck, planes = _regroup(meta, fused, text_len, 2 * sigma)
    glob = (u32(ck[:, :sigma]) << 32) | u32(ck[:, sigma:])
    seg = torch.arange(glob.shape[0], device=glob.device) >> _seg_shift()
    seg_base = glob[::SEG_BLOCKS].contiguous()
    local = (glob - seg_base[seg]).to(torch.int32)
    return _rows(local, planes), seg_base


def stream_table_from_reference(tbl_np: np.ndarray, sigma: int, T: int) -> np.ndarray:
    """The JAX package's stream table (int32 ``[n_tiles*RW', T]``, column b
    of tile t describing block ``t*T + b``) -> this port's rows (int32
    ``[n_tiles*T, RW]``, padding blocks included).

    The reference's rows hold ``rw = sigma + P*4`` words, checkpoints then
    planes.  RW' is its row count per tile: ``rw`` itself when it is a
    multiple of 8, or a multiple of 4 that the reference groups two tiles
    for (while two tiles fit 4 MiB), else ``rw`` padded to a multiple of 8
    (sigma=5: 17 -> 24; sigma^2=25: 45 -> 48).
    """
    rw = sigma + _planes_for(sigma) * LANES
    grouped = rw % 8 == 0 or (rw % 4 == 0 and 8 * rw * T <= 4 << 20)
    rw_ref = rw if grouped else -(-rw // 8) * 8
    rows = np.asarray(tbl_np).reshape(-1, rw_ref, T).transpose(0, 2, 1).reshape(-1, rw_ref)
    out = np.zeros((rows.shape[0], _rw(sigma)), np.int32)
    out[:, :sigma] = rows[:, :sigma].view(np.int32)
    out[:, _plane_off(sigma):] = rows[:, sigma:rw].view(np.int32)
    return out


def stream_table_wide_from_reference(tbl_np: np.ndarray, seg_base_np: np.ndarray,
                                     sigma: int, T: int, text_len: int):
    """The JAX package's wide stream table and its uint32 ``[2, n_segs *
    sigma]`` (hi, lo) segment bases -> this port's rows (int32 [n_blocks,
    RW]) and ``seg_base`` (int64 [n_segs, sigma]).  Both packages cut
    segments at 2^24 blocks, so the local checkpoints carry over."""
    n_rows = stream_rows(text_len)
    lanes = np.asarray(seg_base_np).astype(np.uint64)
    base = ((lanes[0] << np.uint64(32)) | lanes[1]).view(np.int64).reshape(-1, sigma)
    return (stream_table_from_reference(tbl_np, sigma, T)[:n_rows],
            base[:-(-n_rows // SEG_BLOCKS)])


# ---------------------------------------------------------------------------
# the join kernel and its plain version
# ---------------------------------------------------------------------------

def _seg_shift() -> int:
    return SEG_BLOCKS.bit_length() - 1


def join(table: torch.Tensor, key: torch.Tensor, payload: torch.Tensor | None,
         sigma: int, decode: bool, seg_base: torch.Tensor | None = None):
    """Rank (and in decode mode the symbol) at every key.

    ``key``: int64 [N] sentinel-shifted positions, sorted by the caller so
    neighbouring lanes read neighbouring rows (the answer does not depend on
    the order).  ``payload``: int64 [N] whose low 6 bits are the symbol to
    rank (rank mode; None in decode mode).  Returns (rank int64 [N], sym
    int64 [N] or None): ``rank = ckpt[key>>7][sym] + popcount of sym's
    positions in the block before key & 127``; in decode mode sym is the
    block symbol at key.  Keys outside the table give rank 0 and sym 0.

    ``seg_base`` (int64 [n_segs, sigma], the bases of a segment-local
    table) selects the segmented modes: the rank becomes global by adding
    ``seg_base[(key >> 7) >> log2(SEG_BLOCKS), sym]``.
    """
    if key.is_cuda:
        return _join_cuda(table, key, payload, sigma, decode, seg_base, _seg_shift())
    return join_plain(table, key, payload, sigma, decode, seg_base, _seg_shift())


def join_plain(table: torch.Tensor, key: torch.Tensor,
               payload: torch.Tensor | None, sigma: int, decode: bool,
               seg_base: torch.Tensor | None = None, seg_shift: int | None = None):
    """Plain-torch version of the join kernel (row gather + SWAR
    popcount): the CPU path and the kernel's reference.  ``seg_shift``
    (segmented modes) defaults to log2(SEG_BLOCKS)."""
    P = _planes_for(sigma)
    off = _plane_off(sigma)
    blk = key >> SBL_SHIFT
    ok = (key >= 0) & (blk < table.shape[0])
    rows = u32(table[torch.where(ok, blk, 0)])
    rem = key & (SBL - 1)
    planes = rows[:, off:off + P * LANES].reshape(-1, P, LANES)
    if decode:
        lane = (rem >> 5)[:, None, None].expand(-1, P, 1)
        bits = (planes.gather(2, lane)[..., 0] >> (31 - (rem & 31))[:, None]) & 1
        sym = (bits << torch.arange(P, device=key.device)).sum(1)
    else:
        sym = payload & 63
    in_sigma = sym < sigma
    sym_c = sym.clamp(max=sigma - 1)
    ckpt = torch.where(in_sigma, rows.gather(1, sym_c[:, None])[:, 0], 0)
    cnt = popcount32(_combine_planes(planes, sym) & _lane_masks(LANES, rem)).sum(1)
    rank = ckpt + cnt
    if seg_base is not None:
        shift = _seg_shift() if seg_shift is None else seg_shift
        base = seg_base.reshape(-1)[torch.where(ok, (blk >> shift) * sigma + sym_c, 0)]
        rank = rank + torch.where(in_sigma, base, 0)
    rank = torch.where(ok, rank, 0)
    return rank, (torch.where(ok, sym, 0) if decode else None)


def _join_cuda(table, key, payload, sigma, decode, seg_base, seg_shift):
    """Check the arguments and launch the kernel."""
    from .. import kernels

    if not 1 <= sigma <= MAX_SIGMA:
        raise ValueError(f"join kernel serves 1 <= sigma <= {MAX_SIGMA}, got {sigma}")
    dev = key.device
    if not (table.is_cuda and table.device == dev):
        raise ValueError(f"table on {table.device}, keys on {dev}")
    if table.dtype != torch.int32 or table.dim() != 2 or table.shape[1] != _rw(sigma):
        raise ValueError(f"table must be int32 [n, {_rw(sigma)}], got "
                         f"{table.dtype} {list(table.shape)}")
    if not table.is_contiguous() or table.data_ptr() % 16:
        raise ValueError("table must be contiguous and 16-byte aligned")
    if key.dtype != torch.int64 or key.dim() != 1 or not key.is_contiguous():
        raise ValueError("key must be a contiguous int64 vector")
    if not decode and (payload is None or payload.dtype != torch.int64
                       or payload.shape != key.shape or payload.device != dev
                       or not payload.is_contiguous()):
        raise ValueError("rank mode needs a contiguous int64 payload shaped like key")
    if seg_base is not None:
        # every row's segment must have a base: the kernel reads it unchecked
        n_segs = -(-table.shape[0] // (1 << seg_shift))
        if (seg_base.dtype != torch.int64 or seg_base.device != dev
                or not seg_base.is_contiguous() or seg_base.dim() != 2
                or seg_base.shape[1] != sigma or seg_base.shape[0] < n_segs):
            raise ValueError(
                f"seg_base must be a contiguous int64 [>= {n_segs}, {sigma}] tensor on "
                f"{dev}, got {seg_base.dtype} {list(seg_base.shape)} on {seg_base.device}")
    n = key.shape[0]
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    sym = torch.empty(n, dtype=torch.int64, device=dev) if decode else None
    if n == 0:
        return rank, sym
    lib = kernels.join_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sview_join(
            sigma, int(decode), table.data_ptr(), table.shape[0], key.data_ptr(),
            None if decode else payload.data_ptr(),
            None if seg_base is None else seg_base.data_ptr(), seg_shift,
            rank.data_ptr(), None if sym is None else sym.data_ptr(), n,
            ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"join kernel launch failed: {kernels.cuda_error(err)}")
    mode = ("decode" if decode else "rank") + ("" if seg_base is None else "_seg")
    LAUNCHES[mode] += 1
    LAUNCHES_BY_SIGMA[mode, sigma] += 1
    return rank, sym


# ---------------------------------------------------------------------------
# sorted-rank entry points (sort -> kernel -> unsort)
# ---------------------------------------------------------------------------

def rank_next_sorted(table: torch.Tensor, sentinel, pos: torch.Tensor,
                     sym: torch.Tensor, sigma: int,
                     seg_base: torch.Tensor | None = None) -> torch.Tensor:
    """Batched ``get_next_rank`` via sort-join.  pos, sym int64 [N]
    (sym < 64).  Equal to ``ops.rank.rank_next``."""
    key, perm = torch.sort(pos + (pos < sentinel).long())
    ranks, _ = join(table, key, sym[perm].contiguous(), sigma, False, seg_base)
    out = torch.empty_like(ranks)
    out[perm] = ranks
    return out


def pre_rank_and_symidx_sorted(table: torch.Tensor, sentinel, pos: torch.Tensor,
                               sigma: int, seg_base: torch.Tensor | None = None):
    """Batched ``get_pre_rank_and_symidx`` via sort-join.

    Returns (rank int64, symidx int64, is_sentinel bool); rank/symidx are
    garbage where is_sentinel (the caller masks), matching ``ops.rank``.
    """
    is_sentinel = pos == sentinel - 1
    key, perm = torch.sort(pos + (pos < sentinel).long())
    ranks, syms = join(table, key, None, sigma, True, seg_base)
    rank = torch.empty_like(ranks)
    sym = torch.empty_like(syms)
    rank[perm] = ranks
    sym[perm] = syms
    return rank, sym, is_sentinel


def rank_next_sorted_wide(table: torch.Tensor, seg_base: torch.Tensor, sentinel,
                          pos: torch.Tensor, sym: torch.Tensor, sigma: int) -> torch.Tensor:
    """``get_next_rank`` over a segment-local wide table: the sort-join in
    the segmented rank mode, global int64 ranks.  Equal to
    ``ops.wide.rank_next_wide``."""
    return rank_next_sorted(table, sentinel, pos, sym, sigma, seg_base)


def pre_rank_and_symidx_sorted_wide(table: torch.Tensor, seg_base: torch.Tensor,
                                    sentinel, pos: torch.Tensor, sigma: int):
    """``get_pre_rank_and_symidx`` over a segment-local wide table (the
    segmented decode mode).  Equal to ``ops.wide.pre_rank_and_symidx_wide``."""
    return pre_rank_and_symidx_sorted(table, sentinel, pos, sigma, seg_base)
