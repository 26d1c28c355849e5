"""Host-side FmIndex: zero-copy load from blob + exact reference query semantics.

``FmIndex.load`` mirrors ``FmIndex::load`` (``src/load_from_blob.rs:28-85``):
validate magic+version, peel the 5 headers, cross-check body size, then build
zero-copy numpy views over the body sections (the blob may be bytes, a
bytearray, or an ``np.memmap`` for the mmap path).

The scalar query engine here reproduces, op for op:
- kmer-LUT seeding incl. the short-pattern subtree range
  (``count_array.rs:203-223``),
- LF-mapping with the sentinel +1 position shift (``bwm/mod.rs:197-215``),
- the locate walk with sentinel-row short-circuit (``locate/mod.rs:14-37``).

It is the differential oracle for the batched device engine, not the fast path.
"""
from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np

from ..blob import (
    MAGIC,
    BlobLayout,
    BwmHeader,
    CountArrayHeader,
    SuffixArrayHeader,
    aligned_size,
)
from ..config import BlockKind, LoadError, position_dtype
from ..encoders import Encoder, EncodingTable, PassThrough


class FmIndex:
    def __init__(self, blob: np.ndarray, layout: BlobLayout, encoder: Encoder):
        self._blob = blob
        self.layout = layout
        self.encoder = encoder

        lay = layout
        pdt = position_dtype(lay.position)
        psize = pdt.itemsize
        kind = lay.kind

        hdr = lay.ca_header
        _, km_off, kt_off, _ = hdr.body_layout(psize, lay.align)
        base = lay.ca_body_off
        self.count_array = _view(blob, base, hdr.count_array_len, pdt)
        self.kmer_multiplier = _view(blob, base + km_off, hdr.kmer_multiplier_len, np.dtype("<u8"))
        self.kmer_count_table = _view(blob, base + kt_off, hdr.kmer_count_table_len, pdt)

        self.sampling_ratio = lay.sa_header.sampling_ratio
        self.suffix_array = _view(blob, lay.sa_body_off, lay.sa_header.suffix_array_len, pdt)

        ckpt_off, blocks_off, _ = lay.bwm_header.body_layout(psize, kind.block_bytes, lay.align)
        base = lay.bwm_body_off
        self.sentinel_index = int(_view(blob, base, 1, pdt)[0])
        n_blocks = lay.bwm_header.blocks_len
        sigma = lay.bwm_header.symbol_count
        self.rank_checkpoints = _view(blob, base + ckpt_off, n_blocks * sigma, pdt).reshape(
            n_blocks, sigma
        )
        # blocks: LE u32 lanes, reversed per vector to MSB-first lane order
        # (zero-copy negative-stride view).
        le_lanes = _view(
            blob, base + blocks_off, n_blocks * kind.num_planes * kind.num_lanes, np.dtype("<u4")
        ).reshape(n_blocks, kind.num_planes, kind.num_lanes)
        self.lanes = le_lanes[:, :, ::-1]

        self.symbol_count = sigma
        self.kmer_size = hdr.lookup_table_kmer_size
        self.block = kind
        # text_len is not stored directly; derive it from the count-array total
        # (count_array[sigma] == n after the prefix sum).
        self.text_len = int(self.count_array[-1])

    # ------------------------------------------------------------------
    @classmethod
    def load(
        cls,
        blob,
        *,
        position: str = "u32",
        block: BlockKind = BlockKind(3, 64),
        encoder_kind: str = "table",
    ) -> "FmIndex":
        """``encoder_kind``: 'table' (EncodingTable) or 'pass' (PassThrough);
        the caller must know P/B/E, exactly like the reference's type params."""
        buf = blob if isinstance(blob, np.ndarray) else np.frombuffer(blob, dtype=np.uint8)
        align = block.align_size
        # MagicNumber::is_valid (bytes 0-1 == b"FI") + is_supported_version
        # (bytes 2-3 == major/minor b"00"); both gate the load exactly like
        # the reference (magic_number.rs:38-47, load_from_blob.rs:30-33).
        magic = bytes(buf[:8].tobytes()) if len(buf) >= 8 else b""
        if len(magic) < 8 or magic[:2] != MAGIC[:2] or magic[2:4] != MAGIC[2:4]:
            raise LoadError(
                "Invalid FM-index format. The data does not appear to be a valid FM-index blob."
            )
        off = aligned_size(len(MAGIC), align)
        if encoder_kind == "table":
            if len(buf) < off + 256:
                raise LoadError(
                    "Invalid FM-index format. The data does not appear to be a valid FM-index blob."
                )
            encoder = EncodingTable.from_header_bytes(buf[off : off + 256].tobytes())
            enc_size = 256
        elif encoder_kind == "pass":
            encoder = PassThrough()
            enc_size = 0
        else:
            raise LoadError(
                f"unknown encoder kind {encoder_kind!r}; expected 'table' or 'pass'"
            )
        off += aligned_size(enc_size, align)
        try:
            ca_header = CountArrayHeader.unpack(buf[off : off + CountArrayHeader.SIZE].tobytes())
            off += aligned_size(CountArrayHeader.SIZE, align)
            sa_header = SuffixArrayHeader.unpack(buf[off : off + SuffixArrayHeader.SIZE].tobytes())
            off += aligned_size(SuffixArrayHeader.SIZE, align)
            bwm_header = BwmHeader.unpack(buf[off : off + BwmHeader.SIZE].tobytes(), block.block_len)
            off += aligned_size(BwmHeader.SIZE, align)
        except LoadError:
            raise
        except Exception as exc:
            raise LoadError(
                "Invalid FM-index format. The data does not appear to be a valid FM-index blob."
            ) from exc

        layout = BlobLayout(
            position=position,
            kind=block,
            encoder_header_size=enc_size,
            ca_header=ca_header,
            sa_header=sa_header,
            bwm_header=bwm_header,
        )
        if layout.blob_size != len(buf):
            # LoadError::MismatchedBlobSize (load_from_blob.rs:39-58)
            raise LoadError(
                f"Mismatched blob size: headers indicate a total size of "
                f"{layout.blob_size} bytes, but the provided blob is {len(buf)} bytes."
            )
        return cls(buf, layout, encoder)

    def blob(self) -> np.ndarray:
        return self._blob

    def to_device(self, device=None, **kwargs):
        """Upload to a :class:`DeviceFmIndex` for batched device queries on
        ``device`` (None: the current CUDA device; raises where there is
        none).  Keywords as ``DeviceFmIndex.from_host``: ``sa_full`` is the
        optional full (r=1) suffix array (uint32 array, raw file path, or
        ``"device"`` to reconstruct it on the device from the blob's sampled
        SA, see ``build/sa_fill.py``).  The checkpoints and the stream and
        pair tables are derived on ``device``, the CPU included."""
        from .device_index import DeviceFmIndex

        return DeviceFmIndex.from_host(self, device=device, **kwargs)

    # ------------------------------------------------------------------
    # Query engine (scalar oracle)
    # ------------------------------------------------------------------
    def _encode_pattern(self, pattern) -> np.ndarray:
        pat = np.frombuffer(pattern, dtype=np.uint8) if not isinstance(pattern, np.ndarray) else pattern
        return self.encoder.encode(pat)

    def _initial_range(self, sym: np.ndarray) -> tuple[int, int, int]:
        """(lo, hi, remaining_prefix_len)  — count_array.rs:203-223."""
        k = self.kmer_size
        mul = self.kmer_multiplier
        tbl = self.kmer_count_table
        plen = len(sym)
        if plen == 0:
            # the empty pattern: the device index answers 0 and no location;
            # without this the negative indices below wrap to minus the
            # text length
            return 0, 0, 0
        if plen < k:
            start = 0
            for i in range(plen):
                start += (int(sym[i]) + 1) * int(mul[i])
            gap = int(mul[plen - 1]) - 1
            return int(tbl[start - 1]), int(tbl[start + gap]), 0
        start = 0
        for i in range(k):
            start += (int(sym[plen - k + i]) + 1) * int(mul[i])
        return int(tbl[start - 1]), int(tbl[start]), plen - k

    def _rank_next(self, pos: int, symidx: int) -> int:
        """``BwmView::get_next_rank`` (bwm/mod.rs:197-215)."""
        if pos < self.sentinel_index:
            pos += 1
        L = self.block.block_len
        q, rem = divmod(pos, L)
        ckpt = int(self.rank_checkpoints[q, symidx])
        if rem == 0:
            return ckpt
        return ckpt + self._remain_count(q, rem, symidx)

    def _remain_count(self, q: int, rem: int, symidx: int) -> int:
        lanes = self.lanes[q]
        cnt = 0
        for l in range(self.block.num_lanes):
            take = min(max(rem - 32 * l, 0), 32)
            if take == 0:
                break
            m = 0xFFFFFFFF
            for j in range(self.block.num_planes):
                pj = int(lanes[j, l])
                m &= pj if (symidx >> j) & 1 else ~pj & 0xFFFFFFFF
            mask = 0xFFFFFFFF if take == 32 else (0xFFFFFFFF << (32 - take)) & 0xFFFFFFFF
            cnt += (m & mask).bit_count()
        return cnt

    def _pre_rank_and_symidx(self, pos: int):
        """``BwmView::get_pre_rank_and_symidx`` (bwm/mod.rs:217-236);
        None exactly at the sentinel row."""
        if pos == self.sentinel_index - 1:
            return None
        if pos < self.sentinel_index:
            pos += 1
        L = self.block.block_len
        q, rem = divmod(pos, L)
        lanes = self.lanes[q]
        lane, bit = rem >> 5, 31 - (rem & 31)
        symidx = 0
        for j in range(self.block.num_planes):
            symidx |= ((int(lanes[j, lane]) >> bit) & 1) << j
        ckpt = int(self.rank_checkpoints[q, symidx])
        if rem == 0:
            return ckpt, symidx
        return ckpt + self._remain_count(q, rem, symidx), symidx

    def _pos_range(self, pattern) -> tuple[int, int]:
        sym = self._encode_pattern(pattern)
        lo, hi, idx = self._initial_range(sym)
        while lo < hi and idx > 0:
            idx -= 1
            s = int(sym[idx])
            pre = int(self.count_array[s])
            lo = pre + self._rank_next(lo, s)
            hi = pre + self._rank_next(hi, s)
        return lo, hi

    def count(self, pattern) -> int:
        lo, hi = self._pos_range(pattern)
        return hi - lo

    def locate(self, pattern) -> list[int]:
        lo, hi = self._pos_range(pattern)
        return self._locations(lo, hi)

    def locate_to_buffer(self, pattern, buffer: list) -> None:
        """Append locations to a caller buffer (``locate/with_slice.rs:14-18``)."""
        lo, hi = self._pos_range(pattern)
        buffer.extend(self._locations(lo, hi))

    def _locations(self, lo: int, hi: int) -> list[int]:
        """``write_locations_to_buffer`` (locate/mod.rs:14-37)."""
        out = []
        r = self.sampling_ratio
        for pos in range(lo, hi):
            offset = 0
            hit_sentinel = False
            while pos % r != 0:
                pr = self._pre_rank_and_symidx(pos)
                if pr is None:
                    out.append(offset)
                    hit_sentinel = True
                    break
                rank, symidx = pr
                pos = int(self.count_array[symidx]) + rank
                offset += 1
            if not hit_sentinel:
                out.append(int(self.suffix_array[pos // r]) + offset)
        return out

    # Streaming variants (locate/with_rev_iter.rs) -----------------------
    def count_rev_iter(self, pattern_rev_iter: Iterable[int]) -> int:
        lo, hi = self._pos_range_rev_iter(iter(pattern_rev_iter))
        return hi - lo

    def locate_rev_iter(self, pattern_rev_iter: Iterable[int]) -> list[int]:
        lo, hi = self._pos_range_rev_iter(iter(pattern_rev_iter))
        return self._locations(lo, hi)

    def locate_rev_iter_to_buffer(self, pattern_rev_iter: Iterable[int],
                                  buffer: list) -> None:
        """``locate_rev_iter_to_buffer`` (``locate/with_rev_iter.rs:14-18``)."""
        lo, hi = self._pos_range_rev_iter(iter(pattern_rev_iter))
        buffer.extend(self._locations(lo, hi))

    def _pos_range_rev_iter(self, it: Iterator[int]) -> tuple[int, int]:
        """``get_initial_pos_range_and_idx_of_pattern_rev_iter``
        (count_array.rs:235-274) + LF loop (with_rev_iter.rs:21-38)."""
        k = self.kmer_size
        mul = self.kmer_multiplier
        tbl = self.kmer_count_table
        sliced = 0
        start = 0
        while sliced < k:
            sym = next(it, None)
            if sym is None:
                if sliced == 0:  # the empty pattern, as in _initial_range
                    return 0, 0
                start *= (self.symbol_count + 1) ** (k - sliced)
                gap = int(mul[sliced - 1]) - 1
                return int(tbl[start - 1]), int(tbl[start + gap])
            sliced += 1
            start += (self.encoder.idx_of(sym) + 1) * int(mul[k - sliced])
        lo, hi = int(tbl[start - 1]), int(tbl[start])
        while lo < hi:
            sym = next(it, None)
            if sym is None:
                break
            s = self.encoder.idx_of(sym)
            pre = int(self.count_array[s])
            lo = pre + self._rank_next(lo, s)
            hi = pre + self._rank_next(hi, s)
        return lo, hi


def _view(blob: np.ndarray, offset: int, count: int, dtype: np.dtype) -> np.ndarray:
    nbytes = count * dtype.itemsize
    return blob[offset : offset + nbytes].view(dtype)
