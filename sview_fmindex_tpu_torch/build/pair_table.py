"""2-step (pair) occurrence table: two LF steps in one rank query (port of
``sview_fmindex_tpu.build.pair_table``).

For consecutive pattern symbols s1, s2 (s2 processed first)

    step(step(pos, s2), s1) = C2[s2*sigma + s1] + rank2(pos, s2*sigma + s1) - corr

where ``rank2(pos, c)`` counts table entries ``j < p`` (the shifted ``p =
pos + (pos < sentinel)``, ``bwm/mod.rs:202-204``) whose pair code is c; entry
j's code is ``bwt[j]*sigma + next(j)`` with ``next(j)`` the BWT symbol at
the row LF maps occurrence j to; ``C2[s2*sigma+s1] = C[s1] + rank(C[s2],
s1)``.  Exactly one entry j* has no ``next`` (its LF target is the sentinel
row); it is stored with code ``c* = bwt[j*]*sigma`` and the query subtracts
``corr = (c == c*) & (j* < p)``.

LF targets of the k-th occurrence of symbol s are the consecutive rows
``C[s] + k``, so ``next`` over all entries is one gather at
``shifted(C[bwt[j]] + occ_j)``.  The table uses the stream layout
(``ops/stream_join.py``) with sigma' = sigma^2 (4, 9, ..., 49 codes at
sigma 2..7) and is served by the same join kernel.
"""
from __future__ import annotations

import torch

from ..ops import stream_join as sj
from ..ops.rank import rank_next, to_i32, u32

CHUNK = 1 << 27  # positions per build pass (multiple of 128*32)


def _plane_words(meta, fused: torch.Tensor, n_words: int) -> list[torch.Tensor]:
    """Per plane, the position-ordered 32-bit words (int32 [n_words]),
    zero-padded: word ``w`` of plane p is fused lane ``w % fl`` of block
    ``w // fl``."""
    sigma, fl = meta.sigma, meta.num_lanes
    out = []
    for p in range(sj._planes_for(sigma)):
        w = fused[:, sigma + p * fl:sigma + (p + 1) * fl].reshape(-1)
        out.append(torch.cat([w, w.new_zeros(max(n_words - w.shape[0], 0))]))
    return out


def _sym_seq(words, a: int, m: int) -> torch.Tensor:
    """BWT symbols of the contiguous positions [a, a+m) (a, m multiples of
    32): word slices + bit spreading, no gathers."""
    shifts = 31 - torch.arange(32, device=words[0].device)
    sym = None
    for p, w in enumerate(words):
        bits = ((u32(w[a >> 5:(a + m) >> 5])[:, None] >> shifts) & 1).reshape(m)
        sym = bits if sym is None else sym | (bits << p)
    return sym


def _sym_at(words, pos: torch.Tensor) -> torch.Tensor:
    """BWT symbol at each position (one word gather per plane)."""
    bit = 31 - (pos & 31)
    sym = torch.zeros_like(pos)
    for p, w in enumerate(words):
        sym |= ((u32(w[pos >> 5]) >> bit) & 1) << p
    return sym


def build_pair_table_device(meta, fused: torch.Tensor, count_arr: torch.Tensor,
                            sentinel: int, text_len: int):
    """Returns (pair_tbl int32 [n_blocks, RW(sigma^2)], c2 int64 [sigma^2],
    fix int64 [2] = (j_star, c_star)); ``j_star = 0xFFFFFFFF`` when no
    sentinel-target entry exists (n <= 1).  Requires sigma^2 <= 63 (the
    join kernel's symbol budget)."""
    sigma = meta.sigma
    sigma2 = sigma * sigma
    if sigma2 > sj.MAX_SIGMA:
        raise ValueError(f"pair table needs sigma^2 <= 63, got sigma={sigma}")
    n = text_len
    dev = fused.device
    # chunk: a multiple of 128*32 (block and word aligned), no bigger than
    # the text needs
    chunk = min(CHUNK, -(-max(n, 1) // 4096) * 4096)
    n_pad = -(-max(n, 1) // chunk) * chunk
    words = _plane_words(meta, fused, n_pad // 32)
    P2 = sj._planes_for(sigma2)
    shifts = 31 - torch.arange(32, device=dev)
    occ_carry = torch.zeros(sigma, dtype=torch.int64, device=dev)
    code_words = [[] for _ in range(P2)]
    blk_counts = []
    j_star, c_star = 0xFFFFFFFF, 0
    for a in range(0, n_pad, chunk):
        pos = torch.arange(a, a + chunk, device=dev)
        s = _sym_seq(words, a, chunk)
        occ = torch.zeros_like(s)  # exclusive running count of s in [0, j)
        for c in range(sigma):
            is_c = (s == c).long()
            occ = torch.where(is_c == 1, torch.cumsum(is_c, 0) - is_c + occ_carry[c], occ)
            occ_carry[c] += is_c.sum()
        src = count_arr[s] + occ  # LF target (query row)
        real = pos < n
        special = (src == sentinel - 1) & real
        shifted = torch.where(real, src + (src < sentinel).long(), 0)
        nxt = _sym_at(words, shifted)
        # positions >= n are padding, stored as code sigma2: no checkpoint
        # counts it (the bincount below drops it), but its plane bits are set
        # unless sigma2 is a power of two (25 = 0b11001 at sigma 5).  No rank
        # reads them: a key is at most n, and a rank counts only the
        # positions before it in its block.  Decode mode, which reads the
        # position itself, never runs on this table.
        code = torch.where(real, s * sigma + torch.where(special, 0, nxt), sigma2)
        if j_star == 0xFFFFFFFF:
            hits = torch.nonzero(special)
            if hits.numel():
                sp = int(hits[0, 0])
                j_star, c_star = a + sp, int(code[sp])
        bits = code.reshape(-1, 32)
        for p in range(P2):
            code_words[p].append(to_i32((((bits >> p) & 1) << shifts).sum(1)))
        blk = (pos - a) >> sj.SBL_SHIFT
        blk_counts.append(torch.bincount(blk * (sigma2 + 1) + code,
                                         minlength=(chunk // sj.SBL) * (sigma2 + 1))
                          .reshape(-1, sigma2 + 1)[:, :sigma2])
    tbl = _assemble(torch.cat(blk_counts), [torch.cat(w) for w in code_words], n)
    s2v = torch.arange(sigma2, device=dev) // sigma
    s1v = torch.arange(sigma2, device=dev) % sigma
    c2 = count_arr[s1v] + rank_next(meta, fused, sentinel, count_arr[s2v], s1v)
    fix = torch.tensor([j_star, c_star], dtype=torch.int64, device=dev)
    return tbl, c2, fix


def _assemble(counts: torch.Tensor, words: list[torch.Tensor], n: int) -> torch.Tensor:
    """Stream-layout rows from per-block code counts ([n_pad_blocks,
    sigma2]) and per-plane position-ordered code words."""
    n_blocks = sj.stream_rows(n)
    counts = counts[:n_blocks]
    if counts.shape[0] < n_blocks:  # n is a multiple of the chunk
        counts = torch.cat([counts, counts.new_zeros(n_blocks - counts.shape[0],
                                                     counts.shape[1])])
    ckpt = to_i32(torch.cumsum(counts, 0) - counts)
    lanes = []
    for w in words:
        need = n_blocks * sj.LANES
        w = torch.cat([w, w.new_zeros(max(need - w.shape[0], 0))])[:need]
        lanes.append(w.reshape(n_blocks, sj.LANES))
    return sj._rows(ckpt, torch.cat(lanes, dim=1))
