"""Port parity: on-device suffix-array fill (sview_fmindex_tpu_torch/build/sa_fill.py).

The filled SA must equal the builder's ``sa_full_path`` output and the JAX
package's fill, whether the push rounds decode through the join (stream
table) or through fused-row gathers, and whatever the slice of chains
pushed at once (``_FILL_CHAINS`` patched to 1, 7, 64 and left at its
default), on seeded DNA texts and on every u32 interop corpus blob with a
sampled SA.  Exact equality.
"""
import base64
import functools
import json
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import sview_fmindex_tpu as fmx  # noqa: E402
from sview_fmindex_tpu_torch import to_device_torch  # noqa: E402
from sview_fmindex_tpu_torch.build import sa_fill  # noqa: E402

CORPUS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "interop", "corpus")
FILE_CASES = [(10007, 4), (4096, 2), (733, 8)]
SLICES = [1, 7, 64, sa_fill._FILL_CHAINS]


def _fm_and_sa(n, seed, r=2):
    rng = np.random.default_rng(seed)
    text = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n))
    enc = fmx.EncodingTable.from_symbols([b"A", b"C", b"G", b"T"])
    b = fmx.FmIndexBuilder(
        n, 4, enc, position="u32", block=fmx.BLOCK3_U64,
        suffix_array_config=fmx.SuffixArrayConfig.compressed(r),
        lookup_table_config=fmx.LookupTableConfig.kmer_size(3), sa_backend="numpy")
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "sa.u32")
        blob = b.build(text, sa_full_path=p)
        sa_true = np.fromfile(p, dtype="<u4")
    fm = fmx.FmIndex.load(np.frombuffer(blob, np.uint8), position="u32",
                          block=fmx.BLOCK3_U64)
    return fm, sa_true


@pytest.mark.parametrize("n,ratio", [(10007, 4), (4096, 2), (733, 8)])
def test_sa_fill_matches_builder_and_reference(n, ratio):
    fm, sa_true = _fm_and_sa(n, n * 7 + ratio)
    jdev = fm.to_device(sa_full="device", sa_fill_ratio=ratio, dense_lut_entries=0)
    tdev = to_device_torch(fm, "cpu", sa_full="device", sa_fill_ratio=ratio,
                           dense_lut_entries=0)
    assert tdev.meta.has_sa_full
    got = tdev.sa.numpy().view(np.uint32)
    np.testing.assert_array_equal(got, sa_true)
    np.testing.assert_array_equal(got, np.asarray(jdev.sa))
    # the gather-decode rounds (no stream table) fill the same array
    R = fm.sampling_ratio * ratio
    sa_up = torch.from_numpy(fm.suffix_array[::ratio].astype(np.int64))
    gathered = sa_fill.fill_sa_full_device(
        tdev.meta, tdev.fused, tdev.count_arr, tdev.sentinel, sa_up, n, R)
    np.testing.assert_array_equal(gathered.numpy().view(np.uint32), sa_true)


def test_pull_wrap_guards():
    fm, sa_true = _fm_and_sa(3001, 5)
    tdev = to_device_torch(fm, "cpu", dense_lut_entries=0)
    args = (tdev.meta, tdev.fused, tdev.count_arr, tdev.sentinel)
    # too many unfilled rows: the push phase did not run
    with pytest.raises(RuntimeError, match="exceed the wrap-segment bound"):
        sa_fill._pull_wrap(*args, torch.full((1 << 16,), -1, dtype=torch.int32), limit=10)
    # rows that cannot reach a filled row within the step limit
    out = torch.from_numpy(sa_true.view(np.int32).copy())
    out[100:110] = -1
    with pytest.raises(RuntimeError, match="failed to resolve"):
        sa_fill._pull_wrap(*args, out.clone(), limit=0)
    np.testing.assert_array_equal(
        sa_fill._pull_wrap(*args, out, limit=64).numpy().view(np.uint32), sa_true)


# ----------------------------------------------------------------------
# the fill in slices of chains
# ----------------------------------------------------------------------

def _corpus_u32():
    with open(os.path.join(CORPUS, "corpus.json")) as f:
        cases = json.load(f)["cases"]
    return {c["name"]: c for c in cases
            if c["position"] == "u32" and c["sampling_ratio_config"] >= 2}


CORPUS_U32 = _corpus_u32()
CASES = ([pytest.param(("file", n, ratio), id=f"n{n}-x{ratio}") for n, ratio in FILE_CASES]
         + [pytest.param(("corpus", name, ratio), id=f"{name}-x{ratio}")
            for name in CORPUS_U32 for ratio in (1, 3)])


def _corpus_encoder(case):
    if case["encoder"] == "pass":
        return fmx.PassThrough()
    symbols = [base64.b64decode(s) for s in case["symbols"]]
    if case["wildcard_reserved"]:
        return fmx.EncodingTable.from_symbols_with_wildcard(symbols)
    return fmx.EncodingTable.from_symbols(symbols)


@functools.lru_cache(maxsize=None)
def _wanted(case):
    """(fm, fill ratio, the builder's full SA, the JAX package's device fill)
    of a case: a seeded text of ``_fm_and_sa`` or a corpus blob, whose full SA
    the JAX builder writes again from the manifest's text."""
    kind, key, ratio = case
    if kind == "file":
        fm, sa_true = _fm_and_sa(key, key * 7 + ratio)
    else:
        c = CORPUS_U32[key]
        text = base64.b64decode(c["text"])
        b = fmx.FmIndexBuilder(
            len(text), c["symbol_count"], _corpus_encoder(c), position="u32",
            block=getattr(fmx, c["block"]),
            suffix_array_config=fmx.SuffixArrayConfig.compressed(c["sampling_ratio_config"]),
            lookup_table_config=(fmx.LookupTableConfig.kmer_size(c["kmer_size_config"])
                                 if c["kmer_size_config"] > 1 else fmx.LookupTableConfig.none()))
        with tempfile.TemporaryDirectory() as d:
            p = os.path.join(d, "sa.u32")
            blob = bytes(b.build(text, sa_full_path=p))
            sa_true = np.fromfile(p, dtype="<u4")
        with open(os.path.join(CORPUS, c["blob"]), "rb") as f:
            assert f.read() == blob
        fm = fmx.FmIndex.load(np.frombuffer(blob, np.uint8), position="u32",
                              block=getattr(fmx, c["block"]), encoder_kind=c["encoder"])
    jdev = fm.to_device(sa_full="device", sa_fill_ratio=ratio, dense_lut_entries=0)
    return fm, ratio, sa_true, np.asarray(jdev.sa)


@pytest.mark.parametrize("chains", SLICES)
@pytest.mark.parametrize("case", CASES)
def test_sliced_fill_matches_builder_and_reference(monkeypatch, case, chains):
    """The upload's fill (push rounds through the join) in slices of
    ``chains``: byte-equal to the builder's and the JAX package's SA."""
    fm, ratio, sa_true, jsa = _wanted(case)
    monkeypatch.setattr(sa_fill, "_FILL_CHAINS", chains)
    tdev = to_device_torch(fm, "cpu", sa_full="device", sa_fill_ratio=ratio,
                           dense_lut_entries=0)
    assert tdev.stream_tbl is not None
    got = tdev.sa.numpy().view(np.uint32)
    np.testing.assert_array_equal(got, sa_true)
    np.testing.assert_array_equal(got, jsa)
    m = -(-fm.text_len // (fm.sampling_ratio * ratio))
    assert sa_fill.STATS["chains"] == m
    assert sa_fill.STATS["slices"] == -(-m // chains)


@pytest.mark.parametrize("chains", SLICES)
@pytest.mark.parametrize("case", CASES)
def test_sliced_gather_fill_matches_builder_and_reference(monkeypatch, case, chains):
    """The gather-decode rounds (no stream table) in slices of ``chains``."""
    fm, ratio, sa_true, jsa = _wanted(case)
    tdev = to_device_torch(fm, "cpu", dense_lut_entries=0)
    monkeypatch.setattr(sa_fill, "_FILL_CHAINS", chains)
    sa_up = torch.from_numpy(np.asarray(fm.suffix_array[::ratio]).astype(np.int64))
    got = sa_fill.fill_sa_full_device(
        tdev.meta, tdev.fused, tdev.count_arr, tdev.sentinel, sa_up, fm.text_len,
        fm.sampling_ratio * ratio).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, sa_true)
    np.testing.assert_array_equal(got, jsa)


@pytest.mark.parametrize("stream", [True, False], ids=["join", "gather"])
@pytest.mark.parametrize("chains", [1, 7, 64])
def test_live_width_never_exceeds_the_slice(monkeypatch, chains, stream):
    """Every round decodes at most ``_FILL_CHAINS`` keys, the rounds together
    decode every row the push writes, and ``STATS`` says so."""
    fm, ratio, sa_true, _ = _wanted(("file", 10007, 4))
    tdev = to_device_torch(fm, "cpu", dense_lut_entries=0)
    widths = []
    real = sa_fill._decode_sorted

    def recording(meta, fused, stream_tbl, key):
        widths.append(key.shape[0])
        return real(meta, fused, stream_tbl, key)

    monkeypatch.setattr(sa_fill, "_decode_sorted", recording)
    monkeypatch.setattr(sa_fill, "_FILL_CHAINS", chains)
    R = fm.sampling_ratio * ratio
    sa_up = torch.from_numpy(np.asarray(fm.suffix_array[::ratio]).astype(np.int64))
    got = sa_fill.fill_sa_full_device(
        tdev.meta, tdev.fused, tdev.count_arr, tdev.sentinel, sa_up, fm.text_len, R,
        stream_tbl=tdev.stream_tbl if stream else None)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), sa_true)
    m = sa_up.shape[0]
    assert max(widths) <= chains and min(widths) >= 1
    # each unknown row outside the wrap segment is written by one decode
    assert m - 1 <= sum(widths) <= fm.text_len
    assert sa_fill.STATS == dict(chains=m, slices=-(-m // chains), live_width=max(widths),
                                 rounds=len(widths))


def test_seed_makes_no_int64_head_rows(monkeypatch):
    """``_seed`` writes the known rows a slice at a time and returns only the
    int32 SA: no int64 tensor of the m head rows is made beside the
    caller's ``sa_up``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    fm, ratio, _, _ = _wanted(("file", 10007, 4))
    R = fm.sampling_ratio * ratio
    sa_up = torch.from_numpy(np.asarray(fm.suffix_array[::ratio]).astype(np.int64))
    made = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor) and t.dtype == torch.int64:
                    made.append(t.numel())
            return out

    monkeypatch.setattr(sa_fill, "_FILL_CHAINS", 7)
    with Record():
        out = sa_fill._seed(sa_up, fm.text_len, R)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.int32
    assert out.shape == (fm.text_len,)
    assert made and max(made) <= 7
    np.testing.assert_array_equal(out.numpy()[::R].view(np.uint32),
                                  sa_up.numpy().astype(np.uint32))
