"""The plain reference of exact pattern search, in plain PyTorch.

It answers what the FM-index answers, by another method: every suffix of the
text gets an integer key made of its first ``D`` symbols (base ``sigma + 1``,
0 past the end of the text), the keys are sorted, and a pattern's
occurrences are the suffixes whose key lies in the pattern's key range.  A
pattern longer than ``D`` symbols is matched on its first ``D`` by the keys,
and every candidate is then checked symbol by symbol against the text.

It takes only the raw text, the raw patterns with their lengths, and the
configuration's encoding (which bytes form which symbol).  It imports
nothing of the program and reads nothing the program made.

``prefix`` (the control): match only the first ``prefix`` symbols of each
pattern, the answer an index would give that stops at a seed of that
length.  The benchmark must judge that answer wrong.
"""
from __future__ import annotations

import torch

_INT64_LIMIT = 2**63


def code_table(encoding: dict) -> torch.Tensor:
    """int64 [256]: byte -> symbol code 1..sigma (0 is kept for "past the
    end of the text").  ``encoding``: ``{"symbols": ["A", "C", ...],
    "wildcard": bool}``.  Each entry of ``symbols`` lists the bytes of one
    symbol.  A byte in no entry is the last listed symbol, or, with
    ``wildcard``, one more symbol of its own."""
    symbols = encoding["symbols"]
    other = len(symbols) + (1 if encoding.get("wildcard") else 0)
    table = torch.full((256,), other, dtype=torch.int64)
    for code, group in enumerate(symbols, start=1):
        for byte in group.encode():
            table[byte] = code
    return table


def sigma_of(encoding: dict) -> int:
    return len(encoding["symbols"]) + (1 if encoding.get("wildcard") else 0)


def max_digits(base: int) -> int:
    """The most digits of ``base`` whose key range stays below 2^63."""
    d = 0
    while base ** (d + 1) < _INT64_LIMIT:
        d += 1
    return d


class ExactIndex:
    """Sorted ``D``-symbol suffix keys of one text, on ``device``."""

    def __init__(self, text_u8: torch.Tensor, encoding: dict, max_len: int,
                 device: torch.device):
        self.device = device
        self.table = code_table(encoding).to(device)
        self.base = sigma_of(encoding) + 1
        self.n = int(text_u8.shape[0])
        self.max_len = int(max_len)
        self.digits = min(self.max_len, max_digits(self.base))
        text = text_u8.to(device)
        # codes of the text, then max_len zeros: a suffix near the end reads
        # 0 past it, which no symbol of a pattern equals
        self.codes = torch.zeros(self.n + self.max_len, dtype=torch.uint8, device=device)
        self.codes[:self.n] = self.table[text.long()].to(torch.uint8)
        key = torch.zeros(self.n, dtype=torch.int64, device=device)
        for j in range(self.digits):
            key.mul_(self.base).add_(self.codes[j:j + self.n].long())
        self.keys, self.pos = torch.sort(key)
        del key
        self.pow = [self.base ** e for e in range(self.digits + 1)]

    def answer(self, patterns_u8: torch.Tensor, lens: torch.Tensor | None,
               prefix: int | None = None):
        """(counts int64 [B], pid int64 [E], pos int64 [E]): every occurrence
        of each pattern's first ``lens[p]`` symbols (``prefix``: of its first
        ``min(lens[p], prefix)``), sorted by pattern, then position."""
        pats = patterns_u8.to(self.device)
        B, L = pats.shape
        if L > self.max_len:
            raise ValueError(f"patterns of {L} bytes, index built for {self.max_len}")
        lens = (torch.full((B,), L, dtype=torch.int64, device=self.device) if lens is None
                else lens.to(self.device, torch.int64))
        if prefix is not None:
            lens = lens.clamp(max=prefix)
        cols = torch.arange(L, device=self.device)
        codes = torch.where(cols[None, :] < lens[:, None], self.table[pats.long()], 0)
        D = self.digits
        m = lens.clamp(max=D)
        key = torch.zeros(B, dtype=torch.int64, device=self.device)
        for j in range(D):
            digit = codes[:, j] if j < L else torch.zeros_like(key)
            key = key * self.base + digit
        width = torch.tensor(self.pow, dtype=torch.int64, device=self.device)[D - m]
        lo = torch.searchsorted(self.keys, key)
        hi = torch.searchsorted(self.keys, key + width)
        cand = hi - lo
        pid = torch.repeat_interleave(torch.arange(B, device=self.device), cand)
        first = torch.cumsum(cand, 0) - cand
        slot = lo[pid] + torch.arange(pid.shape[0], device=self.device) - first[pid]
        pos = self.pos[slot]
        # symbols past the D the keys hold, checked against the text
        ok = torch.ones_like(pid, dtype=torch.bool)
        for j in range(D, L):
            live = lens[pid] > j
            ok &= ~live | (self.codes[pos + j].long() == codes[pid, j])
        pid, pos = pid[ok], pos[ok]
        # sorted by pattern already; within one, by position
        order = torch.argsort(pid * (self.n + 1) + pos)
        pid, pos = pid[order], pos[order]
        counts = torch.bincount(pid, minlength=B)
        return counts, pid, pos
