"""Pattern batch packing helpers."""
from __future__ import annotations

import numpy as np


def pack_patterns(patterns, pad_to: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """List of byte strings / uint8 arrays -> ([B, Lmax] uint8, lens int32).

    Padding bytes are zeros; they are never read (the search masks by length).
    ``pad_to`` forces a minimum width (useful to keep batch shapes stable).
    """
    arrs = [np.frombuffer(p, np.uint8) if not isinstance(p, np.ndarray) else p.astype(np.uint8, copy=False) for p in patterns]
    lens = np.array([len(a) for a in arrs], dtype=np.int32)
    lmax = max(int(lens.max(initial=1)), pad_to or 1)
    out = np.zeros((len(arrs), lmax), dtype=np.uint8)
    for i, a in enumerate(arrs):
        out[i, : len(a)] = a
    return out, lens
