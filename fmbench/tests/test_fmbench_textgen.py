"""The text generator: the texts of every configuration without
``collection`` are byte for byte what they were before ``collection``
existed, and a collection is what its two numbers say."""
import hashlib
import math

import numpy as np
import pytest
import torch

from fmbench import reference, textgen

DNA = {"symbols": "ACGT"}
PROT = {"symbols": "ARNDCQEGHILKMFPSTWYV"}
WILD_RUNS = {"symbols": "ACGT", "runs": {"byte": "N", "share": 0.01, "mean_len": 200}}
SPECS = {"dna20-1e8": DNA, "prot20-1e8": PROT, "wild5-mini": WILD_RUNS}

# sha256 of make_text's bytes, taken with the generator as it was before
# ``collection`` (text specs of the two configurations and of the data-driven
# test's wild5-mini, with its runs)
GOLDEN = {
    ("dna20-1e8", 1000, 0): "da2fd4aa2421916c14aa1971644b011cc3e59d44e4b9719bf65084d9e5cb3159",
    ("dna20-1e8", 1000, 20260101): "651e6f5e1951ba86fb9505f55cede8160cbf359af66d1c11ec8bddbc1cffb648",
    ("dna20-1e8", 1 << 20, 0): "3df7678125d59e1cd83c3355f4cb698b75dfbcfe7979739894153488449029b9",
    ("dna20-1e8", 1 << 20, 20260101): "aed0026990b58bc0decf683404460943a4bfafff78570a808521def7d6a6514a",
    ("dna20-1e8", textgen.PIECE + 12345, 0): "0af90b26b9f1c0b5f30193f187975a0cfc127d7ddff32ddda159a59fb5f6b9a3",
    ("dna20-1e8", textgen.PIECE + 12345, 20260101): "6c159460e9b63a426ef3fd8b6e6a6d50b10362fdcfa12a6cb7588788328fd542",
    ("prot20-1e8", 1000, 0): "8cfa5e8712c2e8c541c7f554f50bcb54ccc1b38536da575b8d7cf79b89c8d47b",
    ("prot20-1e8", 1000, 20260101): "5681511084f314e3b08ac4b81946b8d929faf53d177201ca4c58084b16eb4ff5",
    ("prot20-1e8", 1 << 20, 0): "c48dcee345d8fa2197eca97f934e5ecc104538e4942f007e14b12caf620d196c",
    ("prot20-1e8", 1 << 20, 20260101): "2a5a0f8a96ca3d44d4150bbf423725a647684cc9129beed4e413348342147ad0",
    ("prot20-1e8", textgen.PIECE + 12345, 0): "ed4683d020d5fcaeca9fbfacca0db9d8f81c32727c4c039a2e9b2f8d886088bf",
    ("prot20-1e8", textgen.PIECE + 12345, 20260101): "e4ae394f5e44a112bbb7fdd5105ec1c9068f3e68d0d3265d1a8742d64299cbf8",
    ("wild5-mini", 1000, 0): "32d9a777268efb5a3b11f33f2b81dcb9e5071a51be2a5835c42b807d79a58eca",
    ("wild5-mini", 1000, 20260101): "fb05746da9fb94f07fda730ab636a612ac1cd9f94ba3afa79ccca657c5e6997b",
    ("wild5-mini", 1 << 20, 0): "d0fcb57c2824ed88f0401bc708a91b6bbd61df72d9b37d8297cb3ab5ba50409b",
    ("wild5-mini", 1 << 20, 20260101): "fca36b70f1790dae8b1fd5e156866260780f9e2f2609e5d1cfb217101d141ec0",
    ("wild5-mini", textgen.PIECE + 12345, 0): "17541f32a71de0845511c6887f555cd7481014c9b45f73670dc07b91d98c3103",
    ("wild5-mini", textgen.PIECE + 12345, 20260101): "446983f1ad7f0607a019e45692c7193d9c6eb47b2bc952913957e365976713bc",
}


def rng(seed: int) -> np.random.Generator:
    """The generator ``run.py`` hands ``make_text`` for ``--seed``."""
    return np.random.default_rng(np.random.SeedSequence(seed & (2**64 - 1), spawn_key=(0,)))


def collection(copies: int, d: float, symbols: str = "ACGT") -> dict:
    return {"symbols": symbols, "collection": {"copies": copies, "substitution_rate": d}}


@pytest.mark.parametrize("name,size,seed", sorted(GOLDEN))
def test_texts_without_collection_are_unchanged(name, size, seed):
    text = textgen.make_text(SPECS[name], size, rng(seed))
    assert text.dtype == np.uint8 and text.shape == (size,)
    assert hashlib.sha256(text.tobytes()).hexdigest() == GOLDEN[name, size, seed]


@pytest.mark.parametrize("size,copies", [(0, 3), (1, 3), (7, 23), (1000, 7), (100_003, 23),
                                         (120_000, 1), (120_000, 8)])
def test_collection_length(size, copies):
    text = textgen.make_text(collection(copies, 0.05), size, rng(11))
    assert text.dtype == np.uint8 and text.shape == (size,)
    assert set(np.unique(text).tolist()) <= set(b"ACGT")


@pytest.mark.parametrize("copies,d,size", [(5, 0.01, 1_000_003), (8, 0.1, 400_000),
                                           (3, 0.5, 90_000)])
def test_each_copy_diverges_from_the_base_by_d(copies, d, size):
    seed = 20260101
    text = textgen.make_text(collection(copies, d), size, rng(seed))
    span = math.ceil(size / copies)
    # the base is the text drawn without ``collection`` at its size
    base = textgen.make_text(DNA, span, rng(seed))
    for i in range(copies):
        copy = text[i * span:(i + 1) * span]
        n = copy.size
        diverged = float((copy != base[:n]).mean())
        band = 4 * math.sqrt(d * (1 - d) / n)
        assert abs(diverged - d) <= band, (i, diverged, d, band)


def test_no_substitution_repeats_the_base_byte():
    """At d = 1 every position of every copy differs from the base, and the
    substitutes are the other distinct bytes, each about as often."""
    size, copies = 300_000, 3
    text = textgen.make_text(collection(copies, 1.0), size, rng(5))
    span = size // copies
    base = textgen.make_text(DNA, span, rng(5))
    for i in range(copies):
        copy = text[i * span:(i + 1) * span]
        assert (copy != base).all()
        for b in b"ACGT":
            got = copy[base == b]
            shares = np.array([(got == o).mean() for o in b"ACGT" if o != b])
            assert abs(shares - 1 / 3).max() < 4 * math.sqrt(2 / 9 / got.size), (i, b, shares)


def test_substitutes_are_drawn_from_the_distinct_bytes():
    """A byte listed twice in ``symbols`` is one byte to substitute: with two
    distinct bytes and d = 1 each copy is the base with the two swapped."""
    size = 40_000
    text = textgen.make_text(collection(2, 1.0, symbols="AAC"), size, rng(9))
    base = textgen.make_text({"symbols": "AAC"}, size // 2, rng(9))
    swapped = np.where(base == ord("A"), ord("C"), ord("A")).astype(np.uint8)
    assert np.array_equal(text[:size // 2], swapped)
    assert np.array_equal(text[size // 2:], swapped)


def test_same_seed_same_bytes():
    spec = dict(collection(23, 0.01), runs=WILD_RUNS["runs"])
    a = textgen.make_text(spec, 500_000, rng(20260101))
    b = textgen.make_text(spec, 500_000, rng(20260101))
    c = textgen.make_text(spec, 500_000, rng(20260102))
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    # the runs are overlaid on the collection
    assert (a == ord("N")).any()


def test_d_zero_repeats_the_base_exactly():
    text = textgen.make_text(collection(4, 0.0), 1000, rng(3))
    base = textgen.make_text(DNA, 250, rng(3))
    assert np.array_equal(text, np.tile(base, 4))


@pytest.mark.parametrize("spec", [
    {"copies": 0, "substitution_rate": 0.01},
    {"copies": 4, "substitution_rate": -0.1},
    {"copies": 4, "substitution_rate": 1.5},
])
def test_collection_out_of_range_raises(spec):
    with pytest.raises(ValueError):
        textgen.make_text({"symbols": "ACGT", "collection": spec}, 1000, rng(1))


def test_one_symbol_cannot_be_substituted():
    with pytest.raises(ValueError):
        textgen.make_text(collection(3, 0.1, symbols="AA"), 1000, rng(1))


def test_windows_occur_once_in_each_copy_they_survive():
    """A 20-bp window occurs about 1 + (C - 1)(1 - d)^40 times: in its own
    copy, and in each other copy where neither side has a substitution in
    it.  Counted by the plain reference over 2000 windows."""
    copies, d, size, L = 8, 0.01, 8 * 60_000, 20
    text = textgen.make_text(collection(copies, d), size, rng(20260101))
    ref = reference.ExactIndex(torch.from_numpy(text), {"symbols": ["A", "C", "G", "T"]}, L,
                               torch.device("cpu"))
    starts = np.random.default_rng(7).integers(0, size - L + 1, size=2000)
    pats = np.lib.stride_tricks.sliding_window_view(text, L)[starts]
    counts, _, _ = ref.answer(torch.from_numpy(np.ascontiguousarray(pats)), None)
    want = 1 + (copies - 1) * (1 - d) ** (2 * L)
    mean = float(counts.double().mean())
    assert abs(mean - want) <= 0.1 * want, (mean, want)
    assert int(counts.min()) >= 1
