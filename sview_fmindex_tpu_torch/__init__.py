"""sview-fmindex-tpu on PyTorch and CUDA: the FM-index engine ported to an
NVIDIA H100.

The package stands alone: it imports neither JAX nor ``sview_fmindex_tpu``.
Its host layer (``config``, ``encoders``, ``blob``, ``build``, ``native``,
``models.builder``, ``models.index``, ``utils.patterns``) is numpy and ctypes
only and keeps the JAX package's module names and its blob format, byte for
byte.  The device layer mirrors the JAX package's modules: ``ops.rank``,
``ops.stream_join`` (with the hand-written join kernel in ``csrc/join.cu``),
``ops.search``, ``ops.locate``, ``build.pair_table``, ``build.sa_fill``,
``build.dense_lut``, ``models.device_index``, ``bench.timing`` and
``parallel`` (``torch.distributed`` in place of a device mesh).
"""

from . import blob, config, encoders  # noqa: F401
from .config import (
    ALL_BLOCK_KINDS,
    BLOCK2_U32,
    BLOCK2_U64,
    BLOCK2_U128,
    BLOCK3_U32,
    BLOCK3_U64,
    BLOCK3_U128,
    BLOCK4_U32,
    BLOCK4_U64,
    BLOCK5_U64,
    BLOCK6_U64,
    BlockKind,
    BuildError,
    LoadError,
    LookupTableConfig,
    SuffixArrayConfig,
)
from .encoders import EncodingTable, PassThrough
from .models.builder import FmIndexBuilder
from .models.index import FmIndex
from .utils.patterns import pack_patterns

from .models.device_index import DeviceFmIndex, IndexMeta, to_device_torch

__all__ = [
    "FmIndexBuilder",
    "FmIndex",
    "DeviceFmIndex",
    "IndexMeta",
    "to_device_torch",
    "pack_patterns",
    "EncodingTable",
    "PassThrough",
    "BlockKind",
    "BuildError",
    "LoadError",
    "LookupTableConfig",
    "SuffixArrayConfig",
    "ALL_BLOCK_KINDS",
    "BLOCK2_U32",
    "BLOCK2_U64",
    "BLOCK2_U128",
    "BLOCK3_U32",
    "BLOCK3_U64",
    "BLOCK3_U128",
    "BLOCK4_U32",
    "BLOCK4_U64",
    "BLOCK5_U64",
    "BLOCK6_U64",
]
