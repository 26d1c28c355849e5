"""The plain reference against a brute-force scan of tiny texts."""
import numpy as np
import pytest
import torch

from fmbench import reference

DNA = {"symbols": ["A", "C", "G", "T"], "wildcard": False}
PROT = {"symbols": list("ARNDCQEGHILKMFPSTWYV"), "wildcard": False}
WILD = {"symbols": ["A", "C", "G", "T"], "wildcard": True}


def scan(text: bytes, enc: dict, pat: bytes) -> list:
    """Every start where the encoded pattern equals the encoded text."""
    table = reference.code_table(enc).numpy()
    t = table[np.frombuffer(text, np.uint8)]
    p = table[np.frombuffer(pat, np.uint8)]
    windows = np.lib.stride_tricks.sliding_window_view(t, len(p))
    return np.flatnonzero((windows == p).all(1)).tolist()


def case(enc, symbols: bytes, n: int, lo: int, hi: int, seed: int, B: int = 300, prefix=None):
    rng = np.random.default_rng(seed)
    text = np.frombuffer(symbols, np.uint8)[rng.integers(0, len(symbols), size=n)]
    starts = rng.integers(0, n - hi + 1, size=B)
    lens = rng.integers(lo, hi + 1, size=B)
    pats = text[starts[:, None] + np.arange(hi)].copy()
    # a fifth of the patterns mutated, so some have no occurrence at all
    mut = rng.random(B) < 0.2
    pats[mut, 0] = np.frombuffer(symbols, np.uint8)[rng.integers(0, len(symbols), size=mut.sum())]
    pats[np.arange(hi)[None, :] >= lens[:, None]] = 0
    ref = reference.ExactIndex(torch.from_numpy(text), enc, hi, torch.device("cpu"))
    counts, pid, pos = ref.answer(torch.from_numpy(pats), torch.from_numpy(lens), prefix=prefix)
    tb = text.tobytes()
    for p in range(B):
        L = int(lens[p]) if prefix is None else min(int(lens[p]), prefix)
        want = scan(tb, enc, pats[p, :L].tobytes())
        got = pos[pid == p].tolist()
        assert got == want, (p, L)
        assert int(counts[p]) == len(want)


@pytest.mark.parametrize("seed", [1, 2])
def test_dna_fixed_and_mixed_lengths(seed):
    case(DNA, b"ACGT", 4000, 3, 12, seed)


def test_protein_longer_than_the_key_digits():
    # base 21 keys hold 14 symbols: longer patterns are checked against the text
    assert reference.max_digits(21) == 14
    case(PROT, b"ARNDCQEGHILKMFPSTWYV", 3000, 10, 30, 3, B=200)


def test_protein_on_repeats_past_the_key_digits():
    # a text of few symbols makes 20-30 aa patterns match on their first 14
    # symbols far more often than on all of them
    case(PROT, b"AR", 3000, 15, 30, 4, B=150)


def test_wildcard_symbol_and_unlisted_bytes():
    case(WILD, b"ACGTN", 3000, 4, 9, 5)
    table = reference.code_table(WILD)
    assert int(table[ord("N")]) == int(table[ord("Z")]) == 5 == reference.sigma_of(WILD)
    assert int(reference.code_table(DNA)[ord("N")]) == 4  # the last listed symbol


def test_prefix_control_matches_only_the_seed():
    case(DNA, b"ACGT", 4000, 8, 12, 6, prefix=5)
