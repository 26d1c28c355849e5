"""The text of a configuration, made from the run's seed.

The text is this system's data, as weights are a model's.  One generator
reads the configuration's ``text`` entry:

- ``"symbols"``: the bytes drawn, uniformly and independently;
- ``"collection"`` (optional): ``{"copies": C, "substitution_rate": d}``
  makes the text a collection of ``C`` near-identical sequences (strains of
  one genome).  A base of ``ceil(size / C)`` symbols is drawn as a text
  without ``collection`` is (it is that text, at that size and seed).  Copy
  ``i`` (``i = 0 .. C-1``) is the base with each position independently
  replaced with probability ``d`` by a byte drawn uniformly from the
  distinct bytes of ``symbols`` other than the base's byte there, so ``d``
  is each copy's divergence from the base.  The text is the copies end to
  end, with no separator, cut to ``size``;
- ``"runs"`` (optional): ``{"byte": "N", "share": 0.01, "mean_len": 1000}``
  overlays runs of one byte (assembly gaps) covering about ``share`` of the
  text, of geometric lengths with that mean.  Applied last.

A text without ``collection`` takes exactly the draws it took before
``collection`` existed, so its bytes are the same for every seed and size.
Drawn in pieces, so the host never holds more than ``PIECE`` entries of
int64 or float64 at once.
"""
from __future__ import annotations

import numpy as np

PIECE = 1 << 26


def make_text(spec: dict, size: int, rng: np.random.Generator) -> np.ndarray:
    """uint8 [size]."""
    alphabet = np.frombuffer(spec["symbols"].encode(), np.uint8)
    collection = spec.get("collection")
    if collection:
        text = _collection(alphabet, collection, size, rng)
    else:
        text = _uniform(alphabet, size, rng)
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


def _uniform(alphabet: np.ndarray, size: int, rng: np.random.Generator) -> np.ndarray:
    text = np.empty(size, np.uint8)
    for a in range(0, size, PIECE):
        b = min(a + PIECE, size)
        text[a:b] = alphabet[rng.integers(0, alphabet.size, size=b - a, dtype=np.uint8)]
    return text


def _collection(alphabet: np.ndarray, spec: dict, size: int,
                rng: np.random.Generator) -> np.ndarray:
    copies, d = int(spec["copies"]), float(spec["substitution_rate"])
    if copies < 1 or not 0.0 <= d <= 1.0:
        raise ValueError(f"collection needs copies >= 1 and 0 <= substitution_rate <= 1: {spec}")
    distinct = np.unique(alphabet)
    if d > 0 and distinct.size < 2:
        raise ValueError("a substitution needs two distinct symbols")
    rank = np.zeros(256, np.int64)
    rank[distinct] = np.arange(distinct.size)
    span = -(-size // copies)
    base = _uniform(alphabet, span, rng)
    text = np.empty(size, np.uint8)
    for i in range(copies):
        a = i * span
        n = min(span, size - a)
        if n <= 0:
            break
        text[a:a + n] = base[:n]
        if d == 0:
            continue
        # the substituted positions of this copy: a Bernoulli(d) process, as
        # gaps of geometric length, drawn a quarter of a piece at a time (at
        # most three such int64 arrays are alive at once)
        draws = min(PIECE // 4, int(n * d * 1.05) + 1024)
        start = 0
        while start < n:
            pos = np.cumsum(rng.geometric(d, size=draws))
            pos += start - 1
            pos = pos[pos < n]
            if pos.size:
                start = int(pos[-1]) + 1
                # another of the distinct bytes: an offset of 1 .. K-1 from
                # the base byte's own rank
                shift = rng.integers(1, distinct.size, size=pos.size)
                shift += rank[base[pos]]
                text[a + pos] = distinct[shift % distinct.size]
            if pos.size < draws:
                break
    return text
