"""Batch intake's host facts (``ops/search.batch_facts``): the LF-loop trip
count, all-dense and the one shared length, from the batch's shape when no
lengths are given and from a min and a max of them otherwise, held equal to
the per-lane numpy formula they replace (copied below as the oracle) on the
benchmark's two configurations (dna20: k 3, dense k 14; prot20: k 2, dense
k 6) and on the same k without a dense seed."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sview_fmindex_tpu_torch.build.dense_lut import auto_dense_k  # noqa: E402
from sview_fmindex_tpu_torch.models.device_index import _as_batch  # noqa: E402
from sview_fmindex_tpu_torch.ops import search as search_ops  # noqa: E402

# name: (sigma, k); dense k from a 2^28-entry dense table, as both
# configurations upload it
CONFIGS = {"dna20": (4, 3), "prot20": (20, 2)}


def meta_of(name):
    sigma, k = CONFIGS[name.split("-")[0]]
    dk = 0 if name.endswith("-nodense") else auto_dense_k(sigma, k, 2 ** 28)
    return types.SimpleNamespace(sigma=sigma, kmer_size=k, dense_k=dk)


METAS = ["dna20", "prot20", "dna20-nodense", "prot20-nodense"]


def oracle(meta, lens, Lmax):
    """The per-lane formula: (steps, all_dense, fixed_len) of host lengths."""
    lens = np.asarray(lens)
    if lens.size == 0:
        steps = 0
    else:
        per = np.maximum(lens - meta.kmer_size, 0)
        if meta.dense_k:
            per = np.where(lens >= meta.dense_k, lens - meta.dense_k, per)
        steps = min(int(per.max()), max(Lmax - meta.kmer_size, 0))
    all_dense = bool(meta.dense_k) and lens.size > 0 and bool((lens >= meta.dense_k).all())
    fixed_len = int(lens[0]) if (lens.size > 0 and (lens == lens[0]).all()) else None
    return steps, all_dense, fixed_len


def _dk(meta):
    """The dense k the cases are cut around (the configuration's own where
    the meta has none)."""
    return meta.dense_k or auto_dense_k(meta.sigma, meta.kmer_size, 2 ** 28)


def _rng(*key):
    return np.random.default_rng([ord(c) for c in "".join(map(str, key))])


# name: meta -> (lens int32 [B], Lmax)
CASES = {
    "equal-above": lambda m: (np.full(300, _dk(m) + 3, np.int32), _dk(m) + 3),
    "equal-at": lambda m: (np.full(300, _dk(m), np.int32), _dk(m)),
    "equal-below": lambda m: (np.full(300, _dk(m) - 1, np.int32), _dk(m) + 2),
    "equal-under-k": lambda m: (np.full(30, m.kmer_size - 1, np.int32), 5),
    "one-lane": lambda m: (np.array([_dk(m) + 1], np.int32), _dk(m) + 1),
    "empty": lambda m: (np.zeros(0, np.int32), 20),
    "spread-above": lambda m: (_rng("above", m).integers(_dk(m), _dk(m) + 12, 500, np.int32),
                               _dk(m) + 12),
    "spread-below": lambda m: (_rng("below", m).integers(0, _dk(m), 500, np.int32), _dk(m)),
    "straddle-with-dk-1": lambda m: (np.r_[_dk(m) - 1, _rng("st1", m).integers(
        1, _dk(m) + 8, 500)].astype(np.int32), _dk(m) + 8),
    "straddle-without-dk-1": lambda m: (_rng("st2", m).choice(
        np.r_[np.arange(1, _dk(m) - 1), np.arange(_dk(m), _dk(m) + 8)], 500).astype(np.int32),
        _dk(m) + 8),
    # the short lanes need more steps than the long ones
    "straddle-short-lanes-most": lambda m: (np.array(
        [_dk(m) - 1] * 5 + [_dk(m)] * 5, np.int32), _dk(m)),
    # the long lanes need more steps than any short lane could
    "straddle-long-lanes-most": lambda m: (np.array(
        [1, 2, _dk(m) - 1, 2 * _dk(m) + 4], np.int32), 2 * _dk(m) + 4),
    "uniform-10-30": lambda m: (_rng("u", m).integers(10, 31, 1000, np.int32), 30),
    "above-lmax-cap-binds": lambda m: (_rng("cap", m).integers(1, 3 * _dk(m), 400, np.int32),
                                       _dk(m)),
    "zero-lengths": lambda m: (np.r_[np.zeros(3), np.full(3, _dk(m) + 2)].astype(np.int32),
                               _dk(m) + 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", METAS)
def test_facts_from_lengths_equal_the_per_lane_formula(name, case):
    meta = meta_of(name)
    lens, Lmax = CASES[case](meta)
    want = oracle(meta, lens, Lmax)
    for given in (lens, lens.astype(np.int64), lens.tolist()):
        assert search_ops.batch_facts(meta, given, len(lens), Lmax) == want, type(given)


# (B, L): no lengths given, every lane of length L
SHAPES = [(0, 20), (0, 0), (1, 20), (1000, 20), (7, 30), (5, 1), (3, 0), (4, 2), (4, 3),
          (4, 5), (4, 6), (4, 13), (4, 14), (4, 15)]


@pytest.mark.parametrize("B,L", SHAPES)
@pytest.mark.parametrize("name", METAS)
def test_facts_from_the_shape_equal_the_per_lane_formula(name, B, L):
    meta = meta_of(name)
    want = oracle(meta, np.full(B, L, np.int32), L)
    assert search_ops.batch_facts(meta, None, B, L) == want


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("name", METAS)
def test_facts_on_random_batches(name, seed):
    meta = meta_of(name)
    rng = np.random.default_rng([seed, METAS.index(name)])
    for _ in range(300):
        B = int(rng.integers(0, 40))
        Lmax = int(rng.integers(0, 40))
        lo = int(rng.integers(0, 40))
        lens = rng.integers(lo, lo + int(rng.integers(1, 12)), B).astype(np.int32)
        want = oracle(meta, lens, Lmax)
        assert search_ops.batch_facts(meta, lens, B, Lmax) == want, (lens, Lmax)


@pytest.mark.parametrize("lens_kind", [None, "numpy", "host-tensor", "list"])
@pytest.mark.parametrize("name", ["dna20", "prot20"])
def test_intake_hands_on_the_same_facts_and_lengths(name, lens_kind):
    """``_as_batch``: the facts equal the oracle's over the lengths it puts
    on the device, which are the batch's own (or all ``L``)."""
    meta = meta_of(name)
    B, L = 64, 30
    rng = np.random.default_rng(5)
    pats = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lens = None if lens_kind is None else rng.integers(1, L + 1, B).astype(np.int32)
    given = {None: None, "numpy": lens, "list": None if lens is None else lens.tolist(),
             "host-tensor": None if lens is None else torch.from_numpy(lens)}[lens_kind]
    got_pats, lens_dev, steps, (all_dense, fixed_len) = _as_batch(
        meta, pats, given, torch.device("cpu"))
    assert torch.equal(got_pats, torch.from_numpy(pats))
    want_lens = np.full(B, L, np.int64) if lens is None else lens.astype(np.int64)
    assert lens_dev.dtype == torch.int64 and np.array_equal(lens_dev.numpy(), want_lens)
    assert (steps, all_dense, fixed_len) == oracle(meta, want_lens, L)


def test_the_configurations_dense_k():
    assert (meta_of("dna20").kmer_size, meta_of("dna20").dense_k) == (3, 14)
    assert (meta_of("prot20").kmer_size, meta_of("prot20").dense_k) == (2, 6)
    assert meta_of("prot20-nodense").dense_k == 0
