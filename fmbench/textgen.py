"""The text of a configuration, made from the run's seed.

The text is this system's data, as weights are a model's.  One generator
reads the configuration's ``text`` entry:

- ``"symbols"``: the bytes drawn, uniformly and independently;
- ``"runs"`` (optional): ``{"byte": "N", "share": 0.01, "mean_len": 1000}``
  overlays runs of one byte (assembly gaps) covering about ``share`` of the
  text, of geometric lengths with that mean.

Drawn in pieces of ``PIECE`` bytes, so the host never holds more than a
piece of int64.
"""
from __future__ import annotations

import numpy as np

PIECE = 1 << 26


def make_text(spec: dict, size: int, rng: np.random.Generator) -> np.ndarray:
    """uint8 [size]."""
    alphabet = np.frombuffer(spec["symbols"].encode(), np.uint8)
    text = np.empty(size, np.uint8)
    for a in range(0, size, PIECE):
        b = min(a + PIECE, size)
        text[a:b] = alphabet[rng.integers(0, alphabet.size, size=b - a, dtype=np.uint8)]
    runs = spec.get("runs")
    if runs:
        mean = float(runs["mean_len"])
        count = max(1, int(size * float(runs["share"]) / mean))
        starts = rng.integers(0, size, size=count)
        lengths = rng.geometric(1.0 / mean, size=count)
        byte = ord(runs["byte"])
        for s, n in zip(starts.tolist(), lengths.tolist()):
            text[s:s + n] = byte
    return text
