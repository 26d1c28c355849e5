"""The port on collections of near-identical genomes, where a 20-bp pattern
occurs once in each copy that carries it, held to the benchmark's plain
reference (``fmbench/reference.py``: sorted 20-symbol suffix keys, plain
PyTorch, nothing of the program).

Texts come from the benchmark's own generator (``fmbench/textgen.py``) at
small sizes: 8 copies of a 50-kbp base at substitution rate 0.01, and 4
exact copies of a 20-kbp base (d = 0), where a window inside a copy occurs
exactly 4 times and one across the seam of two copies 3 times.  From the
exact copies come pattern sets whose overflow (every row but each pattern's
first) is 2^11 and 2^11 + 1, so ``expand_capacity`` is held at the edge of
its rounding.  Each set goes through ``locate_with_counts`` with the
capacity the program sizes and with an exact one given by the caller, on
the pair-stream and gather engines over the full SA and on the LF walk;
every count and every pattern's multiset of positions must equal the
reference's.  Then the ``rows`` and ``slots`` counters: counted only while
a profiler records, ``rows`` only where the program read the counts.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import sview_fmindex_tpu_torch as ft  # noqa: E402
from fmbench import reference, textgen  # noqa: E402
from sview_fmindex_tpu_torch import tracing  # noqa: E402
from sview_fmindex_tpu_torch.ops.locate import expand_capacity  # noqa: E402

ENCODING = {"symbols": ["A", "C", "G", "T"], "wildcard": False}
DENSE = dict(dense_lut_entries=4 ** 6, dense_host_entries=4 ** 5)  # dense_k 6
L = 20
# name: (copies, substitution rate, base length)
TEXTS = {"c8-d01": (8, 0.01, 50_000), "c4-d0": (4, 0.0, 20_000)}
_cache = {}


def text_of(name):
    if ("text", name) not in _cache:
        copies, d, span = TEXTS[name]
        spec = {"symbols": "ACGT", "collection": {"copies": copies, "substitution_rate": d}}
        rng = np.random.default_rng(np.random.SeedSequence(20260101, spawn_key=(len(name),)))
        _cache["text", name] = textgen.make_text(spec, copies * span, rng)
    return _cache["text", name]


def index_of(name, full: bool):
    """The text's index on the CPU: the benchmark's block, position, SA
    sampling and k, with the full SA filled on the device or the LF walk."""
    if ("index", name) not in _cache:
        text = text_of(name)
        enc = ft.EncodingTable.from_symbols([b"A", b"C", b"G", b"T"])
        b = ft.FmIndexBuilder(
            len(text), enc.symbol_count(), enc, position="u32", block=ft.BLOCK3_U64,
            suffix_array_config=ft.SuffixArrayConfig.compressed(2),
            lookup_table_config=ft.LookupTableConfig.kmer_size(3), sa_backend="numpy")
        _cache["index", name] = ft.FmIndex.load(
            np.frombuffer(b.build(text.tobytes()), np.uint8), position="u32",
            block=ft.BLOCK3_U64)
    key = ("dev", name, full)
    if key not in _cache:
        kw = dict(sa_full="device") if full else {}
        _cache[key] = ft.to_device_torch(_cache["index", name], "cpu", **kw, **DENSE)
    return _cache[key]


def windows(text, starts):
    return torch.from_numpy(np.stack([text[s:s + L] for s in starts]))


def pattern_set(name):
    """(text name, [B, 20] uint8 patterns, the count each must have or
    None, the overflow the set must have or None)."""
    if name == "c8-d01":
        text = text_of(name)
        rng = np.random.default_rng(7)
        starts = rng.choice(len(text) - L + 1, size=3000, replace=False)
        return name, windows(text, starts), None, None
    text = text_of("c4-d0")
    copies, _, span = TEXTS["c4-d0"]
    rng = np.random.default_rng(11)
    # windows inside copy 0 occur once in each copy: 3 rows of overflow;
    # windows across the seam of copies 0 and 1 at each of the 3 seams: 2
    inside = rng.choice(span - L + 1, size=700, replace=False)
    seam = span - L + 1 + np.arange(L - 1)
    if name == "c4-d0-inside":
        return "c4-d0", windows(text, inside), copies, None
    if name == "c4-d0-pow2":  # 682 x 3 + 1 x 2 = 2^11
        starts = np.concatenate([inside[:682], seam[:1]])
        return "c4-d0", windows(text, starts), None, 2 ** 11
    if name == "c4-d0-pow2+1":  # 683 x 3 = 2^11 + 1
        return "c4-d0", windows(text, inside[:683]), None, 2 ** 11 + 1
    raise KeyError(name)


def ref_answer(text_name, pats):
    ref = _cache.get(("ref", text_name))
    if ref is None:
        ref = reference.ExactIndex(torch.from_numpy(text_of(text_name)), ENCODING, L,
                                   torch.device("cpu"))
        _cache["ref", text_name] = ref
    return ref.answer(pats, None)


def positions(pid, pos):
    """Each (pattern, position) pair once per occurrence, sorted."""
    return sorted(zip(pid.tolist(), pos.tolist()))


ENGINES = {"stream": (True, True), "gather": (True, False), "walk": (False, True)}
SETS = ["c8-d01", "c4-d0-inside", "c4-d0-pow2", "c4-d0-pow2+1"]


@pytest.mark.parametrize("capacity", ["program", "exact"])
@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("set_name", SETS)
def test_locate_equals_reference_on_collections(set_name, engine, capacity):
    text_name, pats, want_count, want_extra = pattern_set(set_name)
    full, use_stream = ENGINES[engine]
    dev = index_of(text_name, full)
    ref_counts, ref_pid, ref_pos = ref_answer(text_name, pats)
    B = pats.shape[0]
    extra = int((ref_counts - (ref_counts >= 1).long()).sum())
    if want_count is not None:
        assert (ref_counts == want_count).all()
    if want_extra is not None:
        assert extra == want_extra
        # B base slots and the overflow rounded up to a power of two
        k = (want_extra - 1).bit_length()
        assert expand_capacity(ref_counts.numpy()) == B + 2 ** k
    assert int(ref_counts.sum()) > 3 * B
    cap = None if capacity == "program" else B + extra
    locs, pids, valid, counts, dropped = dev.locate_with_counts(
        pats, None, capacity=cap, use_stream=use_stream)
    assert int(dropped.sum()) == 0
    assert locs.shape[0] == (expand_capacity(ref_counts.numpy()) if cap is None else cap)
    assert torch.equal(counts, ref_counts)
    assert positions(pids[valid], locs[valid]) == positions(ref_pid, ref_pos)


def profiled(fn):
    tracing.COUNTS.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        return fn()


@pytest.mark.parametrize("mode", ["traced", "untraced", "caller-capacity"])
def test_rows_and_slots_counters(mode):
    text_name, pats, _, _ = pattern_set("c8-d01")
    dev = index_of(text_name, True)
    ref_counts = ref_answer(text_name, pats)[0]
    rows = int(ref_counts.sum())
    exact = pats.shape[0] + rows - int((ref_counts >= 1).sum())
    if mode == "untraced":
        tracing.COUNTS.clear()
        tracing.COUNTS.update(rows=5, slots=7)
        out = dev.locate_with_counts(pats, None)
        assert dict(tracing.COUNTS) == {"rows": 5, "slots": 7}
        assert torch.equal(out[3], ref_counts)
        return
    cap = exact if mode == "caller-capacity" else None
    locs, _, _, counts, dropped = profiled(lambda: dev.locate_with_counts(pats, None,
                                                                          capacity=cap))
    assert torch.equal(counts, ref_counts) and int(dropped.sum()) == 0
    assert tracing.COUNTS["calls"] == 1
    assert tracing.COUNTS["slots"] == locs.shape[0]
    if mode == "traced":
        assert tracing.COUNTS["rows"] == rows
        assert tracing.COUNTS["slots"] == expand_capacity(ref_counts.numpy())
    else:
        # no counts are read where the caller sizes the buffer
        assert "rows" not in tracing.COUNTS
        assert tracing.COUNTS["slots"] == exact
