"""Text encoders: raw byte -> symbol index.

Mirrors the reference's ``TextEncoder`` trait and its two implementations
(``src/components/text_encoder/``):

- :class:`EncodingTable` — a 256-entry byte table.  Every byte NOT assigned to
  a symbol class maps to the LAST symbol index, which makes the last symbol an
  implicit wildcard (``encoding_table.rs:17-24``).
- :class:`PassThrough` — identity; the text is already symbol indices
  (``pass_through.rs:8-13``).

Both are vectorized over numpy arrays, since the build encodes whole texts
and pattern batches at once rather than byte-at-a-time.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np

BytesLike = Union[bytes, bytearray, memoryview, np.ndarray]


def _as_u8(data: BytesLike) -> np.ndarray:
    arr = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    if arr.dtype != np.uint8:
        arr = arr.astype(np.uint8)
    return arr


class EncodingTable:
    """256-byte symbol table; unindexed bytes -> last symbol (wildcard)."""

    __slots__ = ("table",)

    def __init__(self, table: np.ndarray):
        table = np.asarray(table, dtype=np.uint8)
        assert table.shape == (256,)
        self.table = table

    @classmethod
    def from_symbols(cls, symbols: Sequence[BytesLike]) -> "EncodingTable":
        """The last listed symbol doubles as the wildcard
        (``encoding_table.rs:17-24``: table default = len(symbols)-1)."""
        symbol_count = len(symbols)
        table = np.full(256, symbol_count - 1, dtype=np.uint8)
        for idx, sym in enumerate(symbols):
            for byte in bytes(sym):
                table[byte] = idx
        return cls(table)

    @classmethod
    def from_symbols_with_wildcard(cls, symbols: Sequence[BytesLike]) -> "EncodingTable":
        """Reserve one extra index as a dedicated wildcard
        (``encoding_table.rs:27-34``: table default = len(symbols))."""
        symbol_count = len(symbols) + 1
        table = np.full(256, symbol_count - 1, dtype=np.uint8)
        for idx, sym in enumerate(symbols):
            for byte in bytes(sym):
                table[byte] = idx
        return cls(table)

    def symbol_count(self) -> int:
        """max index + 1 (``encoding_table.rs:35-37``)."""
        return int(self.table.max()) + 1

    def idx_of(self, sym: int) -> int:
        return int(self.table[sym])

    def encode(self, data: BytesLike) -> np.ndarray:
        return self.table[_as_u8(data)]

    # --- blob header protocol -------------------------------------------
    # The EncodingTable IS its own 256-byte header in the blob
    # (``encoding_table.rs`` #[repr(C)] struct of [u8; 256]).
    def header_bytes(self) -> bytes:
        return self.table.tobytes()

    @classmethod
    def from_header_bytes(cls, raw: bytes) -> "EncodingTable":
        return cls(np.frombuffer(raw, dtype=np.uint8, count=256).copy())

    HEADER_SIZE = 256

    def __eq__(self, other):
        return isinstance(other, EncodingTable) and np.array_equal(self.table, other.table)


class PassThrough:
    """Identity encoder: the text already holds symbol indices."""

    __slots__ = ()

    HEADER_SIZE = 0

    def symbol_count(self) -> int:  # pragma: no cover - caller supplies count
        raise TypeError("PassThrough has no inherent symbol count; pass it explicitly")

    def idx_of(self, sym: int) -> int:
        return int(sym)

    def encode(self, data: BytesLike) -> np.ndarray:
        return _as_u8(data)

    def header_bytes(self) -> bytes:
        return b""

    @classmethod
    def from_header_bytes(cls, raw: bytes) -> "PassThrough":
        return cls()

    def __eq__(self, other):
        return isinstance(other, PassThrough)


Encoder = Union[EncodingTable, PassThrough]
