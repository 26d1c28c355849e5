"""FmIndexBuilder: construct the FM-index into one contiguous blob.

Mirrors the reference builder (``src/builder/mod.rs:59-265``): fixed
(text_len, symbol_count, encoder) at init, changeable SA/LUT configs,
``blob_size()`` precomputation, and ``build(text, blob)`` writing 5 headers +
3 bodies in order.  Construction itself is vectorized numpy + the native
SA-IS backend (see ``sview_fmindex_tpu_torch.build``).
"""
from __future__ import annotations

import numpy as np

from ..blob import (
    MAGIC,
    BlobLayout,
    BwmHeader,
    CountArrayHeader,
    SuffixArrayHeader,
)
from ..build import bwm as bwm_build
from ..build import bwt as bwt_build
from ..build import count_array as ca_build
from ..config import BlockKind, BuildError, LookupTableConfig, SuffixArrayConfig, position_dtype
from ..encoders import Encoder, EncodingTable, PassThrough


class FmIndexBuilder:
    def __init__(
        self,
        text_len: int,
        symbol_count: int,
        text_encoder: Encoder,
        *,
        position: str = "u32",
        block: BlockKind = BlockKind(3, 64),
        suffix_array_config: SuffixArrayConfig | None = None,
        lookup_table_config: LookupTableConfig | None = None,
        sa_backend: str | None = None,
    ):
        if symbol_count > block.max_symbol:
            # BuildError::SymbolCountOver (builder/mod.rs:71-73)
            raise BuildError(
                f"The symbol count ({symbol_count}) exceeds the maximum for the "
                f"chosen block type ({block.max_symbol})."
            )
        if position == "u32" and text_len >= 2**32:
            raise BuildError("text too long for u32 positions")
        self.text_len = int(text_len)
        self.symbol_count = int(symbol_count)
        self.text_encoder = text_encoder
        self.position = position
        self.block = block
        self.suffix_array_config = suffix_array_config or SuffixArrayConfig.uncompressed()
        self.lookup_table_config = lookup_table_config or LookupTableConfig.none()
        self.sa_backend = sa_backend

    # Config setters return a new builder (builder/mod.rs:128-159).
    def set_lookup_table_config(self, config: LookupTableConfig) -> "FmIndexBuilder":
        return FmIndexBuilder(
            self.text_len, self.symbol_count, self.text_encoder,
            position=self.position, block=self.block,
            suffix_array_config=self.suffix_array_config,
            lookup_table_config=config, sa_backend=self.sa_backend,
        )

    def set_suffix_array_config(self, config: SuffixArrayConfig) -> "FmIndexBuilder":
        return FmIndexBuilder(
            self.text_len, self.symbol_count, self.text_encoder,
            position=self.position, block=self.block,
            suffix_array_config=config,
            lookup_table_config=self.lookup_table_config, sa_backend=self.sa_backend,
        )

    def layout(self) -> BlobLayout:
        kmer = self.lookup_table_config.resolved_kmer_size(self.symbol_count, self.position)
        ratio = self.suffix_array_config.sampling_ratio()
        return BlobLayout(
            position=self.position,
            kind=self.block,
            encoder_header_size=self.text_encoder.HEADER_SIZE,
            ca_header=CountArrayHeader(self.symbol_count, kmer),
            sa_header=SuffixArrayHeader(ratio, self.text_len),
            bwm_header=BwmHeader(self.symbol_count, self.text_len, self.block.block_len),
        )

    def blob_size(self) -> int:
        return self.layout().blob_size

    def build(self, text, blob: bytearray | memoryview | np.ndarray | None = None,
              sa_full_path: str | None = None) -> bytes | bytearray | np.ndarray:
        """Build the index; returns the blob (new bytes if ``blob`` is None).

        ``sa_full_path``: optionally persist the full (r=1) suffix array as
        uint32 — a derived device-side locate cache (see ``build/bwt.py``).
        """
        lay = self.layout()
        text_u8 = np.frombuffer(text, dtype=np.uint8) if not isinstance(text, np.ndarray) else text.astype(np.uint8, copy=False)
        if len(text_u8) != self.text_len:
            raise BuildError(
                f"Mismatched text length: expected {self.text_len} bytes, but got {len(text_u8)} bytes."
            )
        if blob is None:
            out = np.zeros(lay.blob_size, dtype=np.uint8)
        else:
            out = np.frombuffer(blob, dtype=np.uint8) if not isinstance(blob, np.ndarray) else blob
            if len(out) != lay.blob_size:
                raise BuildError(
                    f"Incorrect blob size: expected {lay.blob_size} bytes, but got {len(out)} bytes."
                )
            out[:] = 0

        pdt = position_dtype(self.position)
        hdr = lay.ca_header
        ratio = lay.sa_header.sampling_ratio

        # 1) headers (builder/mod.rs:211-231)
        out[: len(MAGIC)] = np.frombuffer(MAGIC, np.uint8)
        enc_hdr = self.text_encoder.header_bytes()
        out[lay.encoder_off : lay.encoder_off + len(enc_hdr)] = np.frombuffer(enc_hdr, np.uint8)
        out[lay.ca_header_off : lay.ca_header_off + CountArrayHeader.SIZE] = np.frombuffer(hdr.pack(), np.uint8)
        out[lay.sa_header_off : lay.sa_header_off + SuffixArrayHeader.SIZE] = np.frombuffer(lay.sa_header.pack(), np.uint8)
        out[lay.bwm_header_off : lay.bwm_header_off + BwmHeader.SIZE] = np.frombuffer(lay.bwm_header.pack(), np.uint8)

        # 2) count array body (count_array.rs:78-136)
        table = self.text_encoder.table if isinstance(self.text_encoder, EncodingTable) else None
        padded = bwt_build.padded_text(self.text_len)
        enc_plus1 = ca_build.encode_text(text_u8, table, out=padded[1:-1])
        count_array, kmer_table = ca_build.count_and_kmer_tables(
            enc_plus1, self.symbol_count, hdr.lookup_table_kmer_size
        )
        multiplier = ca_build.kmer_multiplier(self.symbol_count, hdr.lookup_table_kmer_size)
        ca_off, km_off, kt_off, _ = hdr.body_layout(pdt.itemsize, lay.align)
        base = lay.ca_body_off
        _write(out, base + ca_off, count_array.astype(pdt))
        _write(out, base + km_off, multiplier.astype("<u8"))
        _write(out, base + kt_off, kmer_table.astype(pdt))

        # 3) suffix array body + BWT (suffix_array/mod.rs:57-70); the SA
        # lives only inside this call
        bwt_plus1, pidx = bwt_build.bwt_and_sampled_sa(
            padded, ratio, _view(out, lay.sa_body_off, lay.sa_header.suffix_array_len, pdt),
            sa_backend=self.sa_backend, sa_full_path=sa_full_path,
        )
        del padded

        # 4) BWM body (bwm/mod.rs:91-143)
        bh = lay.bwm_header
        ckpt_off, blocks_off, _ = bh.body_layout(pdt.itemsize, self.block.block_bytes, lay.align)
        base = lay.bwm_body_off
        _write(out, base, np.array([pidx], dtype=pdt))
        bwm_build.write_bwm_body(
            bwt_plus1, self.symbol_count, self.block,
            _view(out, base + ckpt_off, bh.rank_checkpoints_len, pdt),
            _view(out, base + blocks_off, bh.blocks_len * self.block.block_bytes, np.uint8),
        )

        return out.tobytes() if blob is None else blob


def _write(out: np.ndarray, offset: int, arr: np.ndarray) -> None:
    raw = np.frombuffer(np.ascontiguousarray(arr).data, np.uint8)
    out[offset : offset + len(raw)] = raw


def _view(out: np.ndarray, offset: int, count: int, dtype) -> np.ndarray:
    """``count`` items of ``dtype`` of the blob from ``offset``: a view the
    build passes write into."""
    dtype = np.dtype(dtype)
    return out[offset : offset + count * dtype.itemsize].view(dtype)
