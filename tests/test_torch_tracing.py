"""The query path's spans and counters (``sview_fmindex_tpu_torch/tracing.py``).

Under ``torch.profiler`` on the CPU, ``locate_with_counts`` and ``count``
emit their layer spans into the profiler's Chrome trace, nested and in
order, and ``tracing.COUNTS`` gives the calls, the batch's bytes on the
index's device, the host's waits for device values and the batches whose
lengths intake scanned on the host, and for a locate the rows located, the
slots of its expand buffer and the bytes read to size it.  With no profiler
recording nothing is counted and ``record_function`` is never entered; the
answers are the same either way.  Three small indexes made from seeded numpy
generators: DNA and protein with the full SA filled on the device, and DNA
without it (the LF walk), whose step tests are counted against the host
oracle's own walk, and whose ``walk_*`` counters appear only where it walks.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import sview_fmindex_tpu_torch as ft  # noqa: E402
from sview_fmindex_tpu_torch import tracing  # noqa: E402
from sview_fmindex_tpu_torch.ops.locate import expand_capacity  # noqa: E402
from sview_fmindex_tpu_torch.utils.patterns import pack_patterns  # noqa: E402

AMINO = b"ARNDCQEGHILKMFPSTWYV"
DNA_DENSE = dict(dense_lut_entries=4 ** 6, dense_host_entries=4 ** 5)  # dense_k 6
PROT_DENSE = dict(dense_lut_entries=20 ** 3, dense_host_entries=20 ** 2)  # dense_k 3
# name: (alphabet bytes, block, k, dense keywords, full SA on the device)
INDEXES = {
    "dna": (b"ACGT", ft.BLOCK3_U64, 3, DNA_DENSE, True),
    "prot": (AMINO, ft.BLOCK5_U64, 2, PROT_DENSE, True),
    "dna-walk": (b"ACGT", ft.BLOCK3_U64, 3, DNA_DENSE, False),
}
N = 5000
B = 96
_cache = {}


def index(name):
    if name not in _cache:
        alphabet, block, k, dense, full = INDEXES[name]
        rng = np.random.default_rng(list(INDEXES).index(name) + 17)
        text = np.frombuffer(alphabet, np.uint8)[rng.integers(0, len(alphabet), size=N)].tobytes()
        enc = ft.EncodingTable.from_symbols([bytes([c]) for c in alphabet])
        b = ft.FmIndexBuilder(
            N, enc.symbol_count(), enc, position="u32", block=block,
            suffix_array_config=ft.SuffixArrayConfig.compressed(4),
            lookup_table_config=ft.LookupTableConfig.kmer_size(k), sa_backend="numpy")
        fm = ft.FmIndex.load(np.frombuffer(b.build(text), np.uint8), position="u32", block=block)
        kw = dict(sa_full="device") if full else {}
        _cache[name] = (text, fm, ft.to_device_torch(fm, "cpu", **kw, **dense))
    return _cache[name]


def batch(name, lens_kind, seed=3):
    """(patterns, lens as the caller hands them, the patterns as bytes):
    uniform 12-symbol windows (``lens`` None), or 4-16 symbols with lengths
    as a numpy array or as a tensor on the index's device."""
    text = index(name)[0]
    rng = np.random.default_rng(seed)
    sizes = [12] * B if lens_kind is None else rng.integers(4, 17, size=B).tolist()
    starts = rng.integers(0, N - 16, size=B)
    pats = [text[s:s + n] for s, n in zip(starts, sizes)]
    packed, lens = pack_patterns(pats)
    packed = torch.from_numpy(np.asarray(packed))
    if lens_kind is None:
        return packed, None, pats
    lens = np.asarray(lens, np.int32)
    return packed, (lens if lens_kind == "host" else torch.from_numpy(lens)), pats


def profiled(fn, path=None):
    """``fn()`` under a CPU profiler, ``COUNTS`` cleared first; with
    ``path`` the trace is written there."""
    tracing.COUNTS.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    if path is not None:
        prof.export_chrome_trace(str(path))
    return out


def program_spans(path):
    events = json.load(open(path))["traceEvents"]
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                  if e.get("cat") == "user_annotation" and e["name"].startswith("fmindex."))


OPS = {
    "locate": ("fmindex.locate", ["fmindex.intake", "fmindex.search", "fmindex.capacity",
                                  "fmindex.resolve"]),
    "locate-capacity": ("fmindex.locate", ["fmindex.intake", "fmindex.search", "fmindex.resolve"]),
    "count": ("fmindex.count", ["fmindex.intake", "fmindex.search"]),
}


def call(dev, op, pats, lens):
    if op == "count":
        return dev.count(pats, lens)
    capacity = 4 * B if op == "locate-capacity" else None
    return dev.locate_with_counts(pats, lens, capacity=capacity)


@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("name,lens_kind", [("dna", None), ("prot", "host")])
def test_spans_nest_in_order(name, lens_kind, op, tmp_path):
    dev = index(name)[2]
    pats, lens, _ = batch(name, lens_kind)
    profiled(lambda: call(dev, op, pats, lens), tmp_path / "trace.json")
    spans = program_spans(tmp_path / "trace.json")
    top, children = OPS[op]
    (t0, t1, got_top), *rest = spans
    assert got_top == top
    assert [s[2] for s in rest] == children
    for a, b, name_ in rest:
        assert t0 <= a <= b <= t1, name_
    # the layers follow one another: none starts before the last one ended
    assert all(rest[i][1] <= rest[i + 1][0] for i in range(len(rest) - 1))


@pytest.mark.parametrize("name,lens_kind", [("dna", None), ("dna", "host"), ("prot", "host"),
                                            ("prot", "device")])
def test_counts_of_a_locate_and_a_count(name, lens_kind):
    dev = index(name)[2]
    pats, lens, _ = batch(name, lens_kind)
    (locs, _, _, counts, _), _ = profiled(
        lambda: (dev.locate_with_counts(pats, lens), dev.count(pats, lens)))
    per_call = pats.numel() + (0 if lens is None else 8 * B)
    # one capacity read per locate; lengths handed in on the index's device
    # are read on the host once per call
    lens_reads = 2 if lens_kind == "device" else 0
    # lengths given are scanned on the host once per call; without them the
    # batch's shape gives the facts
    scans = 0 if lens is None else 2
    # the locate's rows and the 16 bytes of its capacity read (two int64
    # sums reduced on the device), and its buffer's slots
    assert dict(tracing.COUNTS) == {"calls": 2, "intake_bytes": 2 * per_call,
                                    "syncs": 1 + lens_reads, "intake_scans": scans,
                                    "rows": int(counts.sum()), "capacity_bytes": 16,
                                    "slots": locs.shape[0]}
    assert locs.shape[0] == expand_capacity(counts.numpy())


@pytest.mark.parametrize("name,lens_kind", [("dna", None), ("prot", "host"), ("dna-walk", "host")])
def test_capacity_bytes_only_where_the_program_sizes_the_buffer(name, lens_kind):
    dev = index(name)[2]
    pats, lens, _ = batch(name, lens_kind)
    counts = profiled(lambda: [dev.locate_with_counts(pats, lens)[3] for _ in range(3)])[0]
    assert tracing.COUNTS["capacity_bytes"] == 3 * 16
    assert tracing.COUNTS["rows"] == 3 * int(counts.sum())
    locs, _, _, counts, dropped = profiled(
        lambda: dev.locate_with_counts(pats, lens, capacity=4 * B))
    assert int(dropped.sum()) == 0 and locs.shape[0] == 4 * B
    # the caller sized the buffer: nothing was read, so neither is counted
    assert "capacity_bytes" not in tracing.COUNTS and "rows" not in tracing.COUNTS
    assert tracing.COUNTS["slots"] == 4 * B
    # the walk's counters only where the walk ran
    walked = {"walk_steps", "walk_row_steps", "walk_lanes"} <= set(tracing.COUNTS)
    assert walked == (name == "dna-walk")


@pytest.mark.parametrize("op", ["count", "locate"])
@pytest.mark.parametrize("name,lens_kind", [("dna", None), ("dna", "host"), ("dna", "device"),
                                            ("prot", None), ("prot", "host"),
                                            ("prot", "device")])
def test_intake_scans_only_batches_with_lengths(name, lens_kind, op):
    dev = index(name)[2]
    pats, lens, _ = batch(name, lens_kind)
    profiled(lambda: [call(dev, op, pats, lens) for _ in range(3)])
    assert tracing.COUNTS["calls"] == 3
    assert tracing.COUNTS["intake_scans"] == (0 if lens is None else 3)
    assert "intake_scans" in tracing.COUNTS


def host_walk_tests(fm, pats):
    """How often the batched walk tests its rows: once per step of the
    longest walk of any located row (the host oracle's own walk), and once
    more to find none left."""
    r = fm.sampling_ratio
    longest = 0
    for p in pats:
        lo, hi = fm._pos_range(p)
        for pos in range(lo, hi):
            steps = 0
            while pos % r != 0:
                steps += 1
                pr = fm._pre_rank_and_symidx(pos)
                if pr is None:
                    break
                pos = int(fm.count_array[pr[1]]) + pr[0]
            longest = max(longest, steps)
    return longest + 1


@pytest.mark.parametrize("lens_kind", [None, "host"])
def test_walk_adds_its_step_tests_to_the_syncs(lens_kind):
    _, fm, dev = index("dna-walk")
    assert not dev.meta.has_sa_full
    pats, lens, raw = batch("dna-walk", lens_kind)
    profiled(lambda: dev.locate_with_counts(pats, lens))
    walk = host_walk_tests(fm, raw)
    assert walk > 2
    assert tracing.COUNTS["syncs"] == 1 + walk
    assert tracing.COUNTS["calls"] == 1
    # every test but the last finds live rows and decodes them, through a
    # buffer of all the slots
    assert tracing.COUNTS["walk_steps"] == walk - 1
    assert tracing.COUNTS["syncs"] == tracing.COUNTS["walk_steps"] + 2
    assert tracing.COUNTS["walk_lanes"] == (walk - 1) * tracing.COUNTS["slots"]
    assert 0 < tracing.COUNTS["walk_row_steps"] <= tracing.COUNTS["walk_lanes"]


def test_passthrough_batch_on_the_device_is_read_once():
    rng = np.random.default_rng(8)
    text = rng.integers(0, 4, size=N).astype(np.uint8)
    b = ft.FmIndexBuilder(N, 4, ft.PassThrough(), position="u32", block=ft.BLOCK3_U64,
                          suffix_array_config=ft.SuffixArrayConfig.compressed(2),
                          lookup_table_config=ft.LookupTableConfig.kmer_size(3),
                          sa_backend="numpy")
    fm = ft.FmIndex.load(np.frombuffer(b.build(text.tobytes()), np.uint8), position="u32",
                         block=ft.BLOCK3_U64, encoder_kind="pass")
    dev = ft.to_device_torch(fm, "cpu", sa_full="device")
    starts = rng.integers(0, N - 10, size=B)
    pats = torch.from_numpy(np.stack([text[s:s + 10] for s in starts]))
    want = profiled(lambda: dev.count(pats.numpy()))
    assert dict(tracing.COUNTS) == {"calls": 1, "intake_bytes": pats.numel(),
                                    "intake_scans": 0}
    assert torch.equal(profiled(lambda: dev.count(pats)), want)
    assert dict(tracing.COUNTS) == {"calls": 1, "intake_bytes": pats.numel(), "syncs": 1,
                                    "intake_scans": 0}


@pytest.mark.parametrize("name,lens_kind", [("dna", None), ("prot", "host"), ("dna-walk", "host")])
def test_nothing_when_no_profiler_records(name, lens_kind, monkeypatch):
    dev = index(name)[2]
    pats, lens, _ = batch(name, lens_kind)
    tracing.COUNTS.clear()

    def refuse(name_):
        raise AssertionError(f"record_function({name_!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    dev.locate_with_counts(pats, lens)
    dev.locate(pats, lens, capacity=4 * B)
    dev.count(pats, lens)
    dev.pos_ranges(pats, lens)
    assert not tracing.COUNTS


@pytest.mark.parametrize("name,lens_kind", [("dna", None), ("prot", "host"), ("dna-walk", "host")])
def test_answers_equal_with_the_profiler_on(name, lens_kind):
    dev = index(name)[2]
    pats, lens, _ = batch(name, lens_kind)
    plain = (dev.locate_with_counts(pats, lens), dev.count(pats, lens))
    traced = profiled(lambda: (dev.locate_with_counts(pats, lens), dev.count(pats, lens)))
    for a, b in zip((*plain[0], plain[1]), (*traced[0], traced[1])):
        assert torch.equal(a, b)
