"""Byte-compatible blob format.

Implements the reference's one-contiguous-blob layout so blobs are
interchangeable with the Rust crate:

    magic(8) | encoder header | CountArrayHeader(24) | SuffixArrayHeader(16)
    | BwmHeader(24) | CA body | SA body | BWM body

every section padded to the Block's ALIGN_SIZE (``components/mod.rs:1-23``,
write order ``builder/mod.rs:211-262``).  All integers little-endian.

Headers (#[repr(C)] structs):
- MagicNumber: [b'F', b'I', b'0', b'0', 0,0,0,0]  (``magic_number.rs:15-27``)
- CountArrayHeader { symbol_count u32, lookup_table_kmer_size u32,
  count_array_len u32, kmer_multiplier_len u32, kmer_count_table_len u64 }
  (``count_array.rs:10-18``)
- SuffixArrayHeader { sampling_ratio u32, _pad u32, suffix_array_len u64 }
  (``suffix_array/mod.rs:12-18``)
- BwmHeader { symbol_count u32, _pad u32, rank_checkpoints_len u64,
  blocks_len u64 }  (``bwm/mod.rs:9-16``)

Bodies:
- CA: count_array[(sigma+1)] P | kmer_multiplier[k] u64(usize)
      | kmer_count_table[(sigma+1)^k] P      (``count_array.rs:128-135``)
- SA: suffix_array[ceil(n/r)] P              (``suffix_array/mod.rs:57-70``)
- BWM: sentinel_index P | rank_checkpoints[n_blocks*sigma] P
       | blocks[n_blocks] (num_planes vectors each, LE)  (``bwm/mod.rs:106-121``)
"""
from __future__ import annotations

import dataclasses
import struct

import numpy as np

from .config import BlockKind, BuildError, LoadError, position_dtype

MAGIC = b"FI00\x00\x00\x00\x00"


def aligned_size(raw: int, align: int) -> int:
    rem = raw % align
    return raw if rem == 0 else raw + (align - rem)


@dataclasses.dataclass(frozen=True)
class CountArrayHeader:
    symbol_count: int
    lookup_table_kmer_size: int

    SIZE = 24
    _FMT = "<IIIIQ"

    @property
    def count_array_len(self) -> int:
        return self.symbol_count + 1

    @property
    def kmer_multiplier_len(self) -> int:
        return self.lookup_table_kmer_size

    @property
    def kmer_count_table_len(self) -> int:
        return (self.symbol_count + 1) ** self.lookup_table_kmer_size

    def pack(self) -> bytes:
        return struct.pack(
            self._FMT,
            self.symbol_count,
            self.lookup_table_kmer_size,
            self.count_array_len,
            self.kmer_multiplier_len,
            self.kmer_count_table_len,
        )

    @classmethod
    def unpack(cls, raw: bytes) -> "CountArrayHeader":
        sc, k, ca_len, km_len, kt_len = struct.unpack(cls._FMT, raw[: cls.SIZE])
        hdr = cls(sc, k)
        if (ca_len, km_len, kt_len) != (
            hdr.count_array_len,
            hdr.kmer_multiplier_len,
            hdr.kmer_count_table_len,
        ):
            raise LoadError("inconsistent CountArrayHeader derivatives")
        return hdr

    def body_layout(self, psize: int, align: int) -> tuple[int, int, int, int]:
        """(ca_off=0, km_off, kt_off, total_aligned)."""
        ca_raw = self.count_array_len * psize
        km_off = aligned_size(ca_raw, align)
        km_raw = self.kmer_multiplier_len * 8  # usize == u64
        kt_off = km_off + aligned_size(km_raw, align)
        kt_raw = self.kmer_count_table_len * psize
        total = kt_off + aligned_size(kt_raw, align)
        return 0, km_off, kt_off, total


@dataclasses.dataclass(frozen=True)
class SuffixArrayHeader:
    sampling_ratio: int
    text_len: int

    SIZE = 16
    _FMT = "<IIQ"

    @property
    def suffix_array_len(self) -> int:
        # ceil(text_len / ratio)   (suffix_array/mod.rs:43-55)
        q, r = divmod(self.text_len, self.sampling_ratio)
        return q if r == 0 else q + 1

    def pack(self) -> bytes:
        return struct.pack(self._FMT, self.sampling_ratio, 0, self.suffix_array_len)

    @classmethod
    def unpack(cls, raw: bytes) -> "SuffixArrayHeader":
        ratio, _pad, sa_len = struct.unpack(cls._FMT, raw[: cls.SIZE])
        # text_len is not stored; reconstruct a header whose suffix_array_len
        # matches (any text_len with the same ceil works for layout purposes).
        hdr = cls(ratio, sa_len * ratio)
        if hdr.suffix_array_len != sa_len:
            raise LoadError("inconsistent SuffixArrayHeader")
        return hdr

    def body_layout(self, psize: int, align: int) -> int:
        return aligned_size(self.suffix_array_len * psize, align)


@dataclasses.dataclass(frozen=True)
class BwmHeader:
    symbol_count: int
    text_len: int
    block_len: int

    SIZE = 24
    _FMT = "<IIQQ"

    @property
    def blocks_len(self) -> int:
        # one extra block always, for the final checkpoint (bwm/mod.rs:78)
        return self.text_len // self.block_len + 1

    @property
    def rank_checkpoints_len(self) -> int:
        return self.blocks_len * self.symbol_count

    def pack(self) -> bytes:
        return struct.pack(
            self._FMT, self.symbol_count, 0, self.rank_checkpoints_len, self.blocks_len
        )

    @classmethod
    def unpack(cls, raw: bytes, block_len: int) -> "BwmHeader":
        sc, _pad, rc_len, b_len, = struct.unpack(cls._FMT, raw[: cls.SIZE])
        hdr = cls(sc, (b_len - 1) * block_len, block_len)
        if hdr.blocks_len != b_len or hdr.rank_checkpoints_len != rc_len:
            raise LoadError("inconsistent BwmHeader")
        return hdr

    def body_layout(self, psize: int, block_bytes: int, align: int) -> tuple[int, int, int]:
        """(ckpt_off, blocks_off, total_aligned); sentinel at offset 0."""
        ckpt_off = aligned_size(psize, align)
        blocks_off = ckpt_off + aligned_size(self.rank_checkpoints_len * psize, align)
        total = blocks_off + aligned_size(self.blocks_len * block_bytes, align)
        return ckpt_off, blocks_off, total


@dataclasses.dataclass(frozen=True)
class BlobLayout:
    """Absolute offsets of every section for a (position, block, encoder) combo."""

    position: str
    kind: BlockKind
    encoder_header_size: int
    ca_header: CountArrayHeader
    sa_header: SuffixArrayHeader
    bwm_header: BwmHeader

    def __post_init__(self):
        pass

    @property
    def psize(self) -> int:
        return position_dtype(self.position).itemsize

    @property
    def align(self) -> int:
        return self.kind.align_size

    # ---- header offsets --------------------------------------------------
    @property
    def encoder_off(self) -> int:
        return aligned_size(len(MAGIC), self.align)

    @property
    def ca_header_off(self) -> int:
        return self.encoder_off + aligned_size(self.encoder_header_size, self.align)

    @property
    def sa_header_off(self) -> int:
        return self.ca_header_off + aligned_size(CountArrayHeader.SIZE, self.align)

    @property
    def bwm_header_off(self) -> int:
        return self.sa_header_off + aligned_size(SuffixArrayHeader.SIZE, self.align)

    @property
    def header_size(self) -> int:
        return self.bwm_header_off + aligned_size(BwmHeader.SIZE, self.align)

    # ---- body offsets ----------------------------------------------------
    @property
    def ca_body_off(self) -> int:
        return self.header_size

    @property
    def ca_body_size(self) -> int:
        return self.ca_header.body_layout(self.psize, self.align)[3]

    @property
    def sa_body_off(self) -> int:
        return self.ca_body_off + self.ca_body_size

    @property
    def sa_body_size(self) -> int:
        return self.sa_header.body_layout(self.psize, self.align)

    @property
    def bwm_body_off(self) -> int:
        return self.sa_body_off + self.sa_body_size

    @property
    def bwm_body_size(self) -> int:
        return self.bwm_header.body_layout(self.psize, self.kind.block_bytes, self.align)[2]

    @property
    def blob_size(self) -> int:
        return self.bwm_body_off + self.bwm_body_size
