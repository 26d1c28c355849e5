"""DeviceFmIndex: the FM-index as device tensors (port of
``sview_fmindex_tpu.models.device_index``).

The blob's sections become device tensors:

- ``fused``     int32 [n_blocks, sigma + planes*lanes]: rank checkpoints and
  bit-plane lanes per block, so a rank query is one row gather; only the
  plane lanes are copied, the checkpoints are derived on the device,
- ``stream_tbl`` / ``pair_tbl`` int32 [n_blocks128, RW]: the sort-join
  tables for sigma and sigma^2 codes (``ops/stream_join.py``), derived on
  the device from ``fused``,
- ``sa`` int32 [n or ceil(n/r)], ``dense_lo``/``dense_hi`` int32
  [sigma^dk]: 32-bit words holding uint32 values,
- ``kmer_tbl``, ``count_arr``, ``enc_table``, ``pair_c2``, ``pair_fix``:
  small int64 tables.

Wide (u64-position) indexes (``meta.wide_pos``, ``ops/wide.py``) keep
``fused`` as hi | lo | plane words, a segment-local ``stream_tbl`` with
``seg_base`` int64 [n_segs, sigma], and ``sa``, ``kmer_tbl``, ``count_arr``,
``dense_lo``/``dense_hi`` as int64 values.

Positions, ranks, counts and located positions come back as int64 [B] /
[capacity] for every index (the JAX package returns uint32, and uint32
[2, ...] (hi, lo) lanes for wide indexes; the values are identical).
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
import warnings

import numpy as np
import torch

from .. import tracing
from ..build import dense_lut as dense_ops
from ..config import BuildError
from ..ops import locate as locate_ops
from ..ops import rank as rank_ops
from ..ops import search as search_ops
from ..ops import stream_join
from ..ops import wide as wide_ops


@dataclasses.dataclass(frozen=True)
class IndexMeta:
    """Static shape parameters of a device index."""

    sigma: int
    kmer_size: int
    sampling_ratio: int
    block_len: int
    num_planes: int
    num_lanes: int
    dense_k: int = 0  # dense seed-table k (0 = disabled)
    stream_rows: int = 0  # stream-table rows (0 = stream engine disabled)
    pair_rows: int = 0  # pair-table rows (0 = pair engine disabled)
    wide_pos: bool = False  # u64-position index (ops/wide.py)
    has_sa_full: bool = False  # full (r=1) SA resident on device


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """A device tensor of its own holding ``a``, copied straight from the
    host array (blob sections are read-only memmaps: no host copy first,
    and a copy even on the CPU)."""
    with warnings.catch_warnings():
        # from_numpy warns on read-only arrays; the tensor is copied below
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(a)
    return t.to(device, copy=True)


def _i32(a: np.ndarray, device) -> torch.Tensor:
    """uint32 host array -> int32 device tensor with the same bits."""
    return _upload(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32), device)


def _i64(a, device) -> torch.Tensor:
    """Integer host array (uint64 values below 2^63 included) -> int64."""
    a = np.asarray(a)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    return _upload(np.ascontiguousarray(a, dtype=np.int64), device)


def _lanes64(a) -> np.ndarray:
    """The JAX package's uint32 [2, ...] (hi, lo) lanes -> int64 values."""
    a = np.asarray(a).astype(np.uint64)
    return ((a[0] << np.uint64(32)) | a[1]).view(np.int64)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; None means the current CUDA device.
    Without a CUDA device None raises: the CPU serves only a caller who asks
    for it by name."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the index uploads to the current CUDA device by "
            "default; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def planes_effective(fm) -> int:
    """ceil(log2 sigma) device planes: the blob's upper planes are all zero
    for symbols below 2**p, so every upload drops them."""
    return min(fm.block.num_planes, max(1, (fm.symbol_count - 1).bit_length()))


def narrow_fused_rows(fm, planes_eff: int, b0: int = 0, b1: int | None = None) -> np.ndarray:
    """Fused rows of blocks [b0, b1), uint32 [b1 - b0, sigma + planes*lanes]:
    checkpoints | plane lanes.  Assembled per slice, so range-sharded staging
    never holds the whole table."""
    sigma = fm.symbol_count
    b1 = fm.rank_checkpoints.shape[0] if b1 is None else b1
    out = np.empty((b1 - b0, sigma + planes_eff * fm.block.num_lanes), np.uint32)
    out[:, :sigma] = fm.rank_checkpoints[b0:b1].astype(np.uint32)
    out[:, sigma:] = np.ascontiguousarray(fm.lanes[b0:b1, :planes_eff, :]).reshape(b1 - b0, -1)
    return out


def wide_fused_rows(fm, planes_eff: int, b0: int = 0, b1: int | None = None) -> np.ndarray:
    """Wide fused rows of blocks [b0, b1), uint32 [b1 - b0, 2*sigma +
    planes*lanes]: checkpoint hi words | lo words | plane lanes."""
    sigma = fm.symbol_count
    b1 = fm.rank_checkpoints.shape[0] if b1 is None else b1
    out = np.empty((b1 - b0, 2 * sigma + planes_eff * fm.block.num_lanes), np.uint32)
    ck = np.asarray(fm.rank_checkpoints[b0:b1], dtype=np.uint64)
    out[:, :sigma] = (ck >> np.uint64(32)).astype(np.uint32)
    out[:, sigma:2 * sigma] = (ck & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out[:, 2 * sigma:] = np.ascontiguousarray(fm.lanes[b0:b1, :planes_eff, :]).reshape(b1 - b0, -1)
    return out


class _PhaseClock:
    """Seconds per upload phase, device work synchronised at each phase end."""

    def __init__(self, device: torch.device):
        self.device = device
        self.phases: dict = {}
        self.t = time.perf_counter()

    def __call__(self, label: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.phases[label] = now - self.t
        self.t = now


@dataclasses.dataclass
class DeviceFmIndex:
    fused: torch.Tensor
    kmer_tbl: torch.Tensor
    dense_lo: torch.Tensor | None
    dense_hi: torch.Tensor | None
    count_arr: torch.Tensor
    sa: torch.Tensor
    sentinel: int
    enc_table: torch.Tensor
    stream_tbl: torch.Tensor | None
    pair_tbl: torch.Tensor | None
    pair_c2: torch.Tensor | None
    pair_fix: torch.Tensor | None
    meta: IndexMeta
    # wide stream engine only: global counts at segment starts, int64
    # [n_segs, sigma] (ops/stream_join.derive_stream_table_wide)
    seg_base: torch.Tensor | None = None
    # seconds per upload phase (device work synchronised at each phase end)
    upload_phases: dict = dataclasses.field(default_factory=dict)
    # PassThrough index: pattern bytes ARE symbols, so every query batch is
    # checked against sigma on the host (:func:`check_symbols`)
    passthrough: bool = False

    @property
    def device(self) -> torch.device:
        return self.fused.device

    # ------------------------------------------------------------------
    @classmethod
    def from_host(cls, fm, device=None, dense_lut_entries: int | None = 1 << 26,
                  dense_lut_cache: str | None = None,
                  dense_host_entries: int = 1 << 20,
                  stream: bool = True, sa_fill_ratio: int = 4,
                  sa_full: "np.ndarray | str | None" = None,
                  pair: bool = True, force_wide: bool = False) -> "DeviceFmIndex":
        """Upload a host ``FmIndex`` (the blob's zero-copy views) to ``device``
        (None: the current CUDA device; raises where there is none).

        ``dense_lut_entries`` bounds the dense seed table (None or 0
        disables it); ``dense_host_entries`` caps the part built on the host
        (cached in ``dense_lut_cache``, an .npz keyed by a content digest),
        the remaining levels extend on the device.  ``stream`` derives the
        sort-join stream table (sigma <= 63, the join kernel's symbol
        budget), ``pair`` the 2-step pair table (sigma^2 <= 63 codes).  ``sa_full``: the
        full (r=1) suffix array as a uint32 array, a path to a raw
        little-endian uint32 file (``FmIndexBuilder.build(sa_full_path=)``),
        or ``"device"`` to fill it on the device from the sampled SA strided
        to ``sa_fill_ratio``.  Texts of 2^32 bp and more, or ``force_wide``,
        upload the wide engine (:meth:`_from_host_wide`).

        Every narrow upload, to the CPU as to a card, sends only the plane
        columns and derives the checkpoints on ``device``
        (``ops/rank.derive_fused_device``), then the stream and pair tables
        from that fused table.  A narrow upload to a card first builds the
        gather engine's kernel (``csrc/gather_search.cu``), and without a
        full SA the LF walk's (``csrc/lf_walk.cu``), in the phase
        ``kernels``, so that no query pays the compiler, and last checks
        once that the gather kernel takes the tables
        (``ops/search.check_gather_tables``).
        """
        device = resolve_device(device)
        if force_wide or fm.text_len >= 2**32:
            return cls._from_host_wide(fm, device, stream,
                                       dense_host_entries if dense_lut_entries else 0)
        kind = fm.block

        sa_device_fill = isinstance(sa_full, str) and sa_full == "device"
        if sa_device_fill:
            sa_full = None
        if isinstance(sa_full, str):
            sa_full = np.memmap(sa_full, dtype="<u4", mode="r")
        has_sa_full = sa_full is not None or sa_device_fill
        if sa_full is not None:
            if sa_full.shape[0] != fm.text_len:
                raise BuildError(
                    f"sa_full length {sa_full.shape[0]} != text_len {fm.text_len}")
            # a stale cache from a different text of the same length differs
            # almost everywhere: a 64k-probe sample of sa_full[::r] against
            # the blob's sampled SA catches it without paging in the file
            n_sa = fm.suffix_array.shape[0]
            probes = np.unique(np.linspace(0, n_sa - 1, min(n_sa, 65536),
                                           dtype=np.int64))
            if not np.array_equal(
                    np.asarray(sa_full[probes * fm.sampling_ratio]),
                    fm.suffix_array[probes].astype(np.uint32)):
                raise BuildError(
                    "sa_full does not match the blob's sampled suffix array "
                    "(stale or mismatched sa_full cache)")

        # content digest guarding the dense cache: a cache from a different
        # text of the same shape must never be served
        h = hashlib.sha1()
        h.update(np.ascontiguousarray(fm.suffix_array[:65536]).tobytes())
        h.update(np.ascontiguousarray(fm.count_array).tobytes())
        h.update(str((fm.text_len, fm.sentinel_index, kind.num_planes,
                      kind.num_lanes, fm.sampling_ratio)).encode())
        content_digest = h.hexdigest()[:16]

        n_blocks = fm.rank_checkpoints.shape[0]
        sigma = fm.symbol_count
        planes_eff = planes_effective(fm)
        enc_table = _enc_table(fm)

        dk = dense_ops.auto_dense_k(sigma, fm.kmer_size, dense_lut_entries or 0,
                                    text_len=fm.text_len)
        dk_host = min(dk, max(dense_ops.auto_dense_k(
            sigma, fm.kmer_size, dense_host_entries, text_len=fm.text_len),
            fm.kmer_size + 1)) if dk else 0
        phase = _PhaseClock(device)
        if device.type == "cuda":
            # the gather engine's kernel, and the LF walk's where no full SA
            # will be resident, built (once per source) before any query can
            # need them
            from .. import kernels

            kernels.gather_search_lib()
            if not has_sa_full:
                kernels.lf_walk_lib()
            phase("kernels")
        d_lo = d_hi = None
        if dk:
            if dense_lut_cache is not None:
                try:
                    with np.load(dense_lut_cache) as z:
                        # dk AND content digest must match
                        if int(z["dk"]) == dk_host and "digest" in z.files \
                                and str(z["digest"]) == content_digest:
                            d_lo, d_hi = z["lo"], z["hi"]
                except (OSError, KeyError):
                    pass
            if d_lo is None:
                d_lo, d_hi = dense_ops.dense_lut(fm, dk_host)
                if dense_lut_cache is not None:
                    np.savez(dense_lut_cache, dk=dk_host, lo=d_lo, hi=d_hi,
                             digest=content_digest)
        phase("dense_host")

        use_stream_engine = stream and sigma <= stream_join.MAX_SIGMA
        use_pair = pair and use_stream_engine and sigma * sigma <= stream_join.MAX_SIGMA
        n_rows = stream_join.stream_rows(fm.text_len)
        meta = IndexMeta(
            sigma=sigma, kmer_size=fm.kmer_size, sampling_ratio=fm.sampling_ratio,
            block_len=kind.block_len, num_planes=planes_eff,
            num_lanes=kind.num_lanes, dense_k=dk,
            stream_rows=n_rows if use_stream_engine else 0,
            pair_rows=n_rows if use_pair else 0,
            has_sa_full=has_sa_full)

        planes_host = np.ascontiguousarray(fm.lanes[:, :planes_eff, :]).reshape(n_blocks, -1)
        fused_dev = rank_ops.derive_fused_device(meta, _i32(planes_host, device), fm.text_len)
        count_dev = _i64(fm.count_array, device)
        kmer_dev = _i64(fm.kmer_count_table, device)
        enc_dev = _i64(enc_table, device)
        dlo_dev = _i32(d_lo, device) if dk else None
        dhi_dev = _i32(d_hi, device) if dk else None
        sentinel = int(fm.sentinel_index)
        sa_up = sa_dev = None
        ratio = max(int(sa_fill_ratio), 1)
        if sa_device_fill:
            sa_up = _i64(fm.suffix_array[::ratio], device)
        elif sa_full is not None:
            sa_dev = _i32(sa_full, device)
        else:
            sa_dev = _i32(fm.suffix_array, device)
        phase("put")

        stream_dev = None
        if use_stream_engine:
            stream_dev = stream_join.derive_stream_table(meta, fused_dev, fm.text_len)
        phase("stream")

        pair_tbl = pair_c2 = pair_fix = None
        if use_pair:
            from ..build.pair_table import build_pair_table_device

            pair_tbl, pair_c2, pair_fix = build_pair_table_device(
                meta, fused_dev, count_dev, sentinel, fm.text_len)
        phase("pair")

        # the SA fill runs before the dense extension: its output plus its
        # sort transients are the upload's peak device memory
        if sa_device_fill:
            from ..build.sa_fill import fill_sa_full_device

            sa_dev = fill_sa_full_device(
                meta, fused_dev, count_dev, sentinel, sa_up, fm.text_len,
                fm.sampling_ratio * ratio, stream_tbl=stream_dev)
            sa_up = None
        phase("sa_fill")

        if dk and dk > dk_host:
            dlo_dev, dhi_dev = dense_ops.extend_dense_lut_device(
                meta, fused_dev, np.asarray(fm.count_array, dtype=np.int64),
                sentinel, dlo_dev, dhi_dev, dk - dk_host)
        phase("dense_device")
        index = cls(fused=fused_dev, kmer_tbl=kmer_dev, dense_lo=dlo_dev,
                    dense_hi=dhi_dev, count_arr=count_dev, sa=sa_dev,
                    sentinel=sentinel, enc_table=enc_dev, stream_tbl=stream_dev,
                    pair_tbl=pair_tbl, pair_c2=pair_c2, pair_fix=pair_fix,
                    meta=meta, upload_phases=phase.phases,
                    passthrough=is_passthrough(fm))
        if device.type == "cuda":
            # the gather engine's kernel takes these tables without a
            # check a call
            search_ops.check_gather_tables(index)
        return index

    @classmethod
    def _from_host_wide(cls, fm, device: torch.device, stream: bool,
                        dense_host_entries: int) -> "DeviceFmIndex":
        """Upload a u64-position index: the wide engine (``ops/wide.py``).

        As in the JAX upload: dense seeds built on the host only (up to
        ``dense_host_entries``; no device extension), no pair table and no
        full SA, so locate always walks.  The stream engine serves sigma <= 63
        (the join kernel's symbol budget), as in the JAX upload.  Positions are int64 here, so the JAX
        envelope (``validate_wide``: uint32 block and SA folds, ratio <=
        2^15) bounds nothing; the segment-local stream checkpoints fit 32
        bits by construction (``SEG_BLOCKS``).
        """
        kind = fm.block
        sigma = fm.symbol_count
        planes_eff = planes_effective(fm)
        phase = _PhaseClock(device)
        dk = dense_ops.auto_dense_k(sigma, fm.kmer_size, dense_host_entries or 0,
                                    text_len=fm.text_len)
        d_lo, d_hi = dense_ops.dense_lut(fm, dk, wide=True) if dk else (None, None)
        phase("dense_host")
        use_stream_engine = stream and sigma <= stream_join.MAX_SIGMA
        meta = IndexMeta(
            sigma=sigma, kmer_size=fm.kmer_size, sampling_ratio=fm.sampling_ratio,
            block_len=kind.block_len, num_planes=planes_eff, num_lanes=kind.num_lanes,
            dense_k=dk,
            stream_rows=stream_join.stream_rows(fm.text_len) if use_stream_engine else 0,
            wide_pos=True)
        fused_dev = _i32(wide_fused_rows(fm, planes_eff), device)
        sa_dev = _i64(fm.suffix_array, device)
        count_dev = _i64(fm.count_array, device)
        kmer_dev = _i64(fm.kmer_count_table, device)
        enc_dev = _i64(_enc_table(fm), device)
        dlo_dev = _i64(d_lo, device) if dk else None
        dhi_dev = _i64(d_hi, device) if dk else None
        phase("put")
        stream_dev = seg_base = None
        if use_stream_engine:
            stream_dev, seg_base = stream_join.derive_stream_table_wide(
                meta, fused_dev, fm.text_len)
        phase("stream")
        return cls(fused=fused_dev, kmer_tbl=kmer_dev, dense_lo=dlo_dev,
                   dense_hi=dhi_dev, count_arr=count_dev, sa=sa_dev,
                   sentinel=int(fm.sentinel_index), enc_table=enc_dev,
                   stream_tbl=stream_dev, pair_tbl=None, pair_c2=None, pair_fix=None,
                   meta=meta, seg_base=seg_base, upload_phases=phase.phases,
                   passthrough=is_passthrough(fm))

    @classmethod
    def from_reference(cls, arrays: dict, meta, device=None) -> "DeviceFmIndex":
        """Build the port's index from the JAX package's device state:
        ``arrays`` holds ``np.asarray`` of every field of a JAX
        ``DeviceFmIndex``, ``meta`` is its ``IndexMeta``.  Tables are copied
        (stream and pair tables through the layout adapter); ``pair_c2`` and
        ``pair_fix`` are copied as they are; ``pair_gtbl`` and the JAX
        meta's two-symbol gather flag are ignored (the port's gather engine
        ranks one symbol per row gather).  Wide state
        (``meta.wide_pos``): ``fused`` is copied, the (hi, lo) lanes of
        ``sa``, ``kmer_tbl``, ``count_arr``, the dense tables, ``sentinel``
        and ``seg_base`` become int64 values, and the pair placeholders are
        ignored."""
        device = resolve_device(device)
        sigma = meta.sigma
        wide = meta.wide_pos
        vals = _lanes64 if wide else np.asarray
        text_len = int(vals(arrays["count_arr"])[sigma])
        n_rows = stream_join.stream_rows(text_len)

        def table(name, s):
            rows = stream_join.stream_table_from_reference(arrays[name], s, meta.stream_tile)
            return torch.tensor(rows[:n_rows], device=device)

        def dense(name):
            if not meta.dense_k:
                return None
            return _i64(vals(arrays[name]), device) if wide else _i32(arrays[name], device)

        # the JAX upload gates both tables on the kernel's symbol budget
        # (sigma <= 63, sigma^2 <= 63), as the port's does
        stream = bool(meta.stream_rows)
        pair = not wide and bool(meta.pair_rows)
        port_meta = IndexMeta(
            sigma=sigma, kmer_size=meta.kmer_size, sampling_ratio=meta.sampling_ratio,
            block_len=meta.block_len, num_planes=meta.num_planes,
            num_lanes=meta.num_lanes, dense_k=meta.dense_k,
            stream_rows=n_rows if stream else 0, pair_rows=n_rows if pair else 0,
            wide_pos=wide, has_sa_full=meta.has_sa_full)
        stream_tbl = seg_base = None
        if stream and wide:
            rows, base = stream_join.stream_table_wide_from_reference(
                arrays["stream_tbl"], arrays["seg_base"], sigma, meta.stream_tile, text_len)
            stream_tbl = torch.tensor(rows, device=device)
            seg_base = torch.tensor(base, device=device)
        elif stream:
            stream_tbl = table("stream_tbl", sigma)
        return cls(
            fused=_i32(arrays["fused"], device),
            kmer_tbl=_i64(vals(arrays["kmer_tbl"]), device),
            dense_lo=dense("dense_lo"),
            dense_hi=dense("dense_hi"),
            count_arr=_i64(vals(arrays["count_arr"]), device),
            sa=_i64(vals(arrays["sa"]), device) if wide else _i32(arrays["sa"], device),
            sentinel=int(vals(arrays["sentinel"]).reshape(-1)[0]),
            enc_table=_i64(arrays["enc_table"], device),
            stream_tbl=stream_tbl,
            pair_tbl=table("pair_tbl", sigma * sigma) if pair else None,
            pair_c2=_i64(arrays["pair_c2"], device) if pair else None,
            pair_fix=_i64(arrays["pair_fix"], device) if pair else None,
            meta=port_meta, seg_base=seg_base,
            passthrough=np.array_equal(np.asarray(arrays["enc_table"]).reshape(-1),
                                       np.arange(256)))

    # ------------------------------------------------------------------
    # Crossovers measured for the JAX package on a TPU v5e (gather vs
    # stream engine); still to be re-derived on the H100.
    STREAM_MIN_BATCH = 32768
    # above this lane count the gather engine serves the batch, with a warning
    STREAM_MAX_BATCH = 1 << 25

    def _stream(self, B: int, use_stream: bool | None) -> bool:
        if self.meta.stream_rows == 0:
            return False
        if self.meta.wide_pos:
            # wide batches take the stream engine unless asked not to
            return use_stream is not False
        if B >= self.STREAM_MAX_BATCH:
            if use_stream is None or use_stream:
                warnings.warn(
                    f"batch of {B} lanes exceeds the stream engine's "
                    f"{self.STREAM_MAX_BATCH}-lane budget; serving it with the "
                    "gather engine. Chunk the batch.", RuntimeWarning, stacklevel=3)
            return False
        if use_stream is None:
            return B >= self.STREAM_MIN_BATCH
        return use_stream

    def engine_for(self, B: int, use_stream: bool | None = None,
                   use_pair: bool = True) -> str:
        """The engine a batch of ``B`` lanes is served by: ``'gather'`` |
        ``'stream'`` | ``'pair-stream'``, or ``'wide-stream'`` |
        ``'wide-gather'`` for a wide index."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            stream = self._stream(B, use_stream)
        if self.meta.wide_pos:
            return "wide-stream" if stream else "wide-gather"
        if not stream:
            return "gather"
        return "pair-stream" if (use_pair and self.meta.pair_rows) else "stream"

    def _ranges(self, patterns, lens, use_stream, use_pair):
        """(lo, hi, stream): the ranges and whether the stream engine
        served them."""
        with tracing.span("fmindex.intake"):
            patterns, lens, steps, (all_dense, fixed_len) = _as_batch(
                self.meta, patterns, lens, self.device, self.passthrough)
        with tracing.span("fmindex.search"):
            sym = search_ops.encode_patterns(self.enc_table, patterns)
            stream = self._stream(patterns.shape[0], use_stream)
            if self.meta.wide_pos:
                lo, hi = wide_ops.pos_ranges_wide(self, sym, lens, steps, use_stream=stream,
                                                  all_dense=all_dense, fixed_len=fixed_len)
            else:
                lo, hi = search_ops.pos_ranges(
                    self, sym, lens, steps, use_stream=stream, use_pair=use_pair,
                    all_dense=all_dense, fixed_len=fixed_len)
        return lo, hi, stream

    def count(self, patterns, lens=None, use_stream: bool | None = None,
              use_pair: bool = True) -> torch.Tensor:
        """counts int64 [B] for a [B, Lmax] uint8 batch (raw bytes for
        EncodingTable indexes, symbol indices for PassThrough); wide indexes
        too.  ``use_pair=False`` forces the single-symbol engines."""
        with tracing.span("fmindex.count"):
            tracing.count("calls")
            lo, hi, _ = self._ranges(patterns, lens, use_stream, use_pair)
            return hi - lo

    def pos_ranges(self, patterns, lens=None, use_stream: bool | None = None):
        """(lo, hi) int64 [B], wide indexes too."""
        return self._ranges(patterns, lens, use_stream, True)[:2]

    def locate(self, patterns, lens=None, capacity: int | None = None,
               use_stream: bool | None = None, use_pair: bool = True):
        """(locations int64 [capacity], pattern_ids int64, valid bool,
        dropped int64 [1]); wide indexes too.  Slot ``p < B`` is pattern p's
        first occurrence, slots ``B..`` the overflow
        (``ops.locate.expand_ranges``).  With ``capacity=None`` it is sized
        from the counts; callers passing a capacity must check ``dropped ==
        0``."""
        locs, pids, valid, _, dropped = self.locate_with_counts(
            patterns, lens, capacity, use_stream, use_pair)
        return locs, pids, valid, dropped

    def locate_with_counts(self, patterns, lens=None, capacity: int | None = None,
                           use_stream: bool | None = None, use_pair: bool = True):
        """(locs, pids, valid, counts, dropped), all int64 / bool tensors;
        no host sync when ``capacity`` is given (the plain walk, off a card,
        still syncs once per step).  Without a ``capacity`` the buffer is
        sized from two sums of the counts reduced on the device and read as
        16 bytes (``ops.locate.device_capacity``).  Traced, it counts the expand
        buffer's ``slots``, and without a ``capacity`` the ``rows`` located
        and the ``capacity_bytes`` read to size it."""
        with tracing.span("fmindex.locate"):
            tracing.count("calls")
            lo, hi, stream = self._ranges(patterns, lens, use_stream, use_pair)
            counts = hi - lo
            if capacity is None:
                with tracing.span("fmindex.capacity"):
                    capacity, rows = locate_ops.device_capacity(counts)
                    tracing.count("rows", rows)
            tracing.count("slots", capacity)
            with tracing.span("fmindex.resolve"):
                locs, pids, valid, dropped = self.resolve_rows(lo, hi, capacity, stream)
            return locs, pids, valid, counts, dropped

    def resolve_rows(self, lo, hi, capacity: int, use_stream: bool = False):
        """Expand [lo, hi) ranges and resolve rows to locations: (locs,
        pids, valid, dropped).  ``use_stream`` lets the LF walk decode
        through the join kernel."""
        stream = use_stream and self.stream_tbl is not None
        if self.meta.wide_pos:
            return wide_ops.locate_rows_wide(
                self.meta, self.fused, self.count_arr, self.sa, self.sentinel, lo, hi,
                capacity, self.stream_tbl, self.seg_base, stream)
        return locate_ops.locate_rows(self.meta, self.fused, self.count_arr,
                                      self.sa, self.sentinel, lo, hi, capacity,
                                      self.stream_tbl, stream)


def is_passthrough(fm) -> bool:
    """Whether ``fm`` takes pattern bytes as symbols.  Decided by what the
    encoder offers (a ``table``), not by its class: an ``FmIndex`` of the
    JAX package, whose classes are not this package's, uploads the same
    way."""
    return getattr(fm.encoder, "table", None) is None


def _enc_table(fm) -> np.ndarray:
    """256-entry byte -> symbol table (the identity for PassThrough)."""
    if is_passthrough(fm):
        return np.arange(256, dtype=np.int64)
    return np.asarray(fm.encoder.table).astype(np.int64)


def check_symbols(patterns, sigma: int) -> None:
    """Raise ``ValueError`` if a byte of the [B, L] batch (padding included:
    finished lanes still gather by it) is not a symbol of a PassThrough index,
    naming the first such symbol and its pattern.  An ``EncodingTable`` maps
    every byte, so only PassThrough indexes call this; it runs before anything
    of the batch is gathered by, on the CPU and on the card alike (there an
    out-of-range gather would be a device-side assert that ends the
    process's CUDA context)."""
    if isinstance(patterns, torch.Tensor):
        if patterns.numel() == 0 or int(patterns.max()) < sigma:
            return
        patterns = patterns.cpu().numpy()
    else:
        patterns = np.asarray(patterns)
        if patterns.size == 0 or int(patterns.max()) < sigma:
            return
    patterns = patterns.reshape(-1, patterns.shape[-1])
    p, j = (int(x[0]) for x in np.nonzero(patterns >= sigma))
    raise ValueError(
        f"symbol {int(patterns[p, j])} at position {j} of pattern {p} is outside the "
        f"index's alphabet (a PassThrough index takes pattern bytes as symbols 0..{sigma - 1})")


def to_device_torch(fm, device=None, **kwargs) -> DeviceFmIndex:
    """``FmIndex.to_device`` for any host index of the blob format: upload
    ``fm`` to ``device`` (None: the current CUDA device; keywords as
    ``DeviceFmIndex.from_host``: ``dense_lut_entries``, ``dense_lut_cache``,
    ``dense_host_entries``, ``stream``, ``sa_fill_ratio``, ``sa_full``,
    ``pair``, ``force_wide``)."""
    return DeviceFmIndex.from_host(fm, device=device, **kwargs)


def _as_batch(meta, patterns, lens, device, passthrough: bool = False):
    """Normalise the batch to a uint8 [B, L] device tensor and derive host
    facts: LF steps, and ``(all_dense, fixed_len)`` — every lane long enough
    for the dense seed, and one shared length.  ``passthrough``: the bytes
    are symbols and are checked against sigma first."""
    if isinstance(patterns, torch.Tensor):
        patterns = patterns.to(dtype=torch.uint8)
    else:
        patterns = np.asarray(patterns, dtype=np.uint8)
    if passthrough:
        if isinstance(patterns, torch.Tensor) and patterns.device == device \
                and patterns.numel():
            # check_symbols reads the batch's largest byte on the host
            tracing.count("syncs")
        check_symbols(patterns, meta.sigma)
    if isinstance(patterns, torch.Tensor):
        patterns = patterns.to(device)
    else:
        patterns = torch.as_tensor(patterns, device=device)
    if patterns.dim() == 1:
        patterns = patterns[None, :]
    B, L = patterns.shape
    if lens is None:
        lens_host = None
        lens_dev = torch.full((B,), L, dtype=torch.int64, device=device)
    else:
        if isinstance(lens, torch.Tensor):
            if lens.device == device:
                tracing.count("syncs")
            lens = lens.cpu().numpy()
        lens_host = np.asarray(lens, dtype=np.int32).reshape(-1)
        lens_dev = torch.as_tensor(lens_host.astype(np.int64), device=device)
        tracing.count("intake_bytes", lens_dev.numel() * lens_dev.element_size())
    tracing.count("intake_bytes", patterns.numel())
    # lengths given are read on the host; else the shape gives the facts
    tracing.count("intake_scans", int(lens_host is not None))
    steps, all_dense, fixed_len = search_ops.batch_facts(meta, lens_host, B, L)
    return patterns, lens_dev, steps, (all_dense, fixed_len)
