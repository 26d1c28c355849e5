"""The port's engine matrix on a card (``@pytest.mark.cuda``; skipped without one).

Configurations: every case of the interop corpus (``interop/corpus/``: seven
block kinds, sigma 4, 5, 9, 20, 24 and 40, u32 and u64 positions, k 1-3, r
1-4), each loaded from its committed blob and, beside it, built by the port
over a seeded text of 30-40 k symbols at the case's block, position,
encoder, k and r.  Each configuration is uploaded narrow with every option
of ``DeviceFmIndex.from_host`` (:data:`NARROW_VARIANTS`) and with
``force_wide`` (:data:`WIDE_VARIANTS`; 2-64 block segments, so the wide table
spans several), once to the card with no device named and once to the CPU.
Four combinations of options (:data:`COMBOS`) run on two configurations.
Each case holds:

- the state: every tensor of the card upload equals the CPU upload's;
- the answers: uniform 20 (the pair chain), uniform 21 (the odd pass), mixed
  lengths 1-30 (some shorter than k, some holding bytes outside the alphabet
  where the encoder maps them), B=1, B=0 and, for a corpus blob, the
  manifest's queries go through ``pos_ranges``, ``count``,
  ``locate_with_counts`` and ``resolve_rows`` at a capacity that drops
  occurrences, on both engines: the card's answers equal the CPU's tensor for
  tensor, and the host ``FmIndex``'s counts and sorted locations (and the
  manifest's);
- the kernels: the join modes the case must run (rank on a stream call,
  decode in the SA fill, their segmented modes on a wide upload, there with
  decode in the walk) launched on the card, and no other; the LF walk's
  kernel launched where a narrow upload has no full SA, and only there.

The answers' JAX half is held on the CPU tier (``test_torch_device_index.py``,
``test_torch_wide.py``, ``test_torch_alphabets.py``, ``test_torch_corpus.py``);
this file imports no JAX, so on a machine without it the card cases run with
``python -m pytest tests/test_torch_card_matrix.py -m cuda --noconftest``
(``tests/conftest.py`` imports JAX).  With ``SVIEW_CARD_LAUNCHES`` naming a
path, the module writes its join launches there as JSON, by mode and by
``mode@sigma``.
"""
import base64
import collections
import inspect
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import sview_fmindex_tpu_torch as ft  # noqa: E402
from sview_fmindex_tpu_torch.models import device_index as DI  # noqa: E402
from sview_fmindex_tpu_torch.ops import locate as locate_ops  # noqa: E402
from sview_fmindex_tpu_torch.ops import stream_join as sj  # noqa: E402

CORPUS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "interop", "corpus")
with open(os.path.join(CORPUS, "corpus.json")) as _f:
    CASES = {c["name"]: c for c in json.load(_f)["cases"]}
SOURCES = ("corpus", "seeded")
CONFIGS = [f"{src}-{name}" for name in CASES for src in SOURCES]

# one upload per keyword of ``DeviceFmIndex.from_host``: the keywords a
# variant sets, and whether it applies at a given sigma (pair tables exist
# at sigma 2-7 only).  ``None`` values are filled per configuration by
# :func:`_variant_kwargs`.
NARROW_VARIANTS = {
    "default": ({}, lambda s: True),
    "sa_device": (dict(sa_full="device", sa_fill_ratio=3, dense_lut_entries=None,
                       dense_host_entries=None), lambda s: True),
    "no_dense": (dict(dense_lut_entries=0), lambda s: True),
    "no_stream": (dict(stream=False), lambda s: True),
    "no_pair": (dict(pair=False), lambda s: s * s <= sj.MAX_SIGMA),
    "sa_array": (dict(sa_full=None), lambda s: True),
    "sa_file": (dict(sa_full=None), lambda s: True),
    "cached": (dict(dense_lut_cache=None), lambda s: True),
}
# options set together, each on COMBO_CONFIGS only (the card suite's time
# is bounded): ``sa_full=None`` stands for the full SA as a given array
COMBOS = {
    "sa_device_ratio_1": dict(sa_full="device", sa_fill_ratio=1),
    "no_stream_sa_device": dict(stream=False, sa_full="device"),
    "no_pair_sa_device": dict(pair=False, sa_full="device", sa_fill_ratio=3),
    "no_dense_sa_array_no_stream": dict(dense_lut_entries=0, sa_full=None, stream=False),
}
# the main path's configuration and wildcard DNA: both have pair tables
COMBO_CONFIGS = ("seeded-dna_b3u64_k3r2", "seeded-wild_b3u64_k3r2")
# the wide upload takes only ``stream`` and the dense seed's size
WIDE_VARIANTS = {
    "default": ({}, lambda s: True),
    "no_stream": (dict(stream=False), lambda s: True),
    "no_dense": (dict(dense_lut_entries=0), lambda s: True),
}
# a committed blob goes up as users load it, with the device SA fill, and
# wide; every variant runs on the seeded text of the same configuration,
# whose tables span many more rows
CORPUS_VARIANTS = {(False, "default"), (False, "sa_device"), (True, "default")}
# variants whose state is another variant's, built another way (held equal
# to the CPU upload's tensor for tensor): their answers are asked on the
# mixed batch (and the manifest's) only
BUILT_ALIKE = {"sa_file", "cached"}
BATCH_B = 40  # patterns per drawn batch


def _params():
    out = []
    for cfg in CONFIGS:
        sigma = CASES[cfg.split("-", 1)[1]]["symbol_count"]
        for wide, variants in ((False, NARROW_VARIANTS), (True, WIDE_VARIANTS)):
            for name, (_, applies) in variants.items():
                if applies(sigma) and (cfg.startswith("seeded")
                                       or (wide, name) in CORPUS_VARIANTS):
                    out.append(pytest.param(cfg, wide, name,
                                            id=f"{cfg}-{'wide' if wide else 'narrow'}-{name}"))
    out += [pytest.param(cfg, False, name, id=f"{cfg}-narrow-{name}")
            for cfg in COMBO_CONFIGS for name in COMBOS]
    return out


PARAMS = _params()


@pytest.fixture(scope="module", autouse=True)
def launch_record():
    """Write this module's join launches to ``$SVIEW_CARD_LAUNCHES``."""
    before = collections.Counter(sj.LAUNCHES), collections.Counter(sj.LAUNCHES_BY_SIGMA)
    yield
    path = os.environ.get("SVIEW_CARD_LAUNCHES")
    if path:
        modes = collections.Counter(sj.LAUNCHES) - before[0]
        by_sigma = collections.Counter(sj.LAUNCHES_BY_SIGMA) - before[1]
        with open(path, "w") as f:
            json.dump({"launches": dict(modes),
                       "by_sigma": {f"{m}@{s}": n for (m, s), n in sorted(by_sigma.items())}}, f)


@pytest.fixture(scope="module", autouse=True)
def host_dense_once():
    """The host's part of the dense seed table (``build/dense_lut.dense_lut``,
    a numpy pass over the blob that the CPU tier holds to the JAX package)
    is built once per index, depth and width and handed to every upload
    that asks for it: the card's and the CPU's alike."""
    built = {}
    real = DI.dense_ops.dense_lut

    def dense_lut(fm, dk, *args, **kwargs):
        key = id(fm), dk, args, tuple(sorted(kwargs.items()))
        if key not in built:
            built[key] = fm, real(fm, dk, *args, **kwargs)  # fm kept: its id stays its own
        return built[key][1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DI.dense_ops, "dense_lut", dense_lut)
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.cuda.set_device(0)
    return torch.device("cuda", 0)


# ----------------------------------------------------------------------
# configurations
# ----------------------------------------------------------------------

def _encoder(case):
    if case["encoder"] == "pass":
        return ft.PassThrough()
    symbols = [base64.b64decode(s) for s in case["symbols"]]
    if case["wildcard_reserved"]:
        return ft.EncodingTable.from_symbols_with_wildcard(symbols)
    return ft.EncodingTable.from_symbols(symbols)


def _seeded_text(case, seed: int) -> bytes:
    """30-40 k symbols: symbol indices for PassThrough, else every byte of
    every symbol class (both cases of ``Aa``), and for a table encoder a few
    bytes outside the alphabet (the wildcard, or the last symbol)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(30_000, 40_001))
    sigma = case["symbol_count"]
    if case["encoder"] == "pass":
        return bytes(range(sigma)) + rng.integers(0, sigma, n, dtype=np.uint8).tobytes()
    classes = [np.frombuffer(base64.b64decode(s), np.uint8) for s in case["symbols"]]
    # each class's first and last byte: both cases of ``Aa``
    ends = np.array([[c[0], c[-1]] for c in classes], np.uint8)
    text = ends[rng.integers(0, len(classes), n), rng.integers(0, 2, n)]
    outside = np.frombuffer(b"N#~", np.uint8)
    text[rng.integers(0, n, n // 200)] = outside[rng.integers(0, 3, n // 200)]
    return text.tobytes()


def _outside_bytes(case) -> bytes:
    """Bytes that no symbol class lists (empty for PassThrough: every byte
    there is a symbol or refused)."""
    if case["encoder"] == "pass":
        return b""
    listed = set(b"".join(base64.b64decode(s) for s in case["symbols"]))
    return bytes(b for b in b"N#~n@" if b not in listed)


def _draw(text: bytes, rng, B: int, lens, outside: bytes):
    """``B`` patterns of the given lengths: most taken from the text, an
    eighth random symbols, and (with ``outside``) an eighth holding one
    byte outside the alphabet."""
    arr = np.frombuffer(text, np.uint8)
    out = []
    for i in range(B):
        m = int(lens[i])
        s = int(rng.integers(0, len(text) - m))
        p = bytearray(arr[s:s + m].tobytes())
        if i % 8 == 1:
            p = bytearray(rng.choice(np.unique(arr), m).tobytes())
        elif i % 8 == 5 and outside:
            p[int(rng.integers(0, m))] = outside[int(rng.integers(0, len(outside)))]
        out.append(bytes(p))
    return out


def _batches(cfg: dict) -> dict:
    """name -> (patterns uint8 [B, L], lens or None, list of pattern bytes)."""
    case, text = cfg["case"], cfg["text"]
    rng = np.random.default_rng(len(text))
    outside = _outside_bytes(case)

    def draw(B, lens):
        return _draw(text, rng, B, lens, outside)

    out = {}
    for L in (20, 21):
        pats = draw(BATCH_B, [L] * BATCH_B)
        out[f"u{L}"] = (np.frombuffer(b"".join(pats), np.uint8).reshape(BATCH_B, L), None, pats)
    # lengths 1-30, two of them below k (the k-mer subtree path) where k > 1;
    # length 1-2 patterns are rare: their thousands of locations cost the
    # host oracle
    lens = rng.integers(3, 31, BATCH_B)
    lens[:2] = [1, max(2, case["kmer_size_config"] - 1)]
    pats = draw(BATCH_B, lens)
    out["mixed"] = (*ft.pack_patterns(pats), pats)
    one = draw(1, [17])
    out["b1"] = (np.frombuffer(one[0], np.uint8)[None, :].copy(), None, one)
    out["b0"] = (np.zeros((0, 8), np.uint8), None, [])
    if cfg["source"] == "corpus":
        pats = [base64.b64decode(q["pattern"]) for q in case["queries"]]
        out["manifest"] = (*ft.pack_patterns(pats), pats)
    return out


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Configurations built so far, by id, and where their files go."""
    return {"dir": tmp_path_factory.mktemp("card_matrix")}


def _config(cfg_id: str, built: dict) -> dict:
    """The host index of a configuration, its full SA file, its batches and
    the host oracle's answers (built once per module)."""
    if cfg_id in built:
        return built[cfg_id]
    source, name = cfg_id.split("-", 1)
    case = CASES[name]
    text = (base64.b64decode(case["text"]) if source == "corpus"
            else _seeded_text(case, sum(map(ord, name))))
    k, r = case["kmer_size_config"], case["sampling_ratio_config"]
    b = ft.FmIndexBuilder(
        len(text), case["symbol_count"], _encoder(case), position=case["position"],
        block=getattr(ft, case["block"]),
        suffix_array_config=(ft.SuffixArrayConfig.compressed(r) if r > 1
                             else ft.SuffixArrayConfig.uncompressed()),
        lookup_table_config=(ft.LookupTableConfig.kmer_size(k) if k > 1
                             else ft.LookupTableConfig.none()),
        sa_backend="numpy")
    sa_path = str(built["dir"] / f"{cfg_id}.sa")
    blob = np.frombuffer(bytes(b.build(text, sa_full_path=sa_path)), np.uint8)  # + the full SA
    if source == "corpus":  # the committed file, as users load it
        blob = np.fromfile(os.path.join(CORPUS, case["blob"]), dtype=np.uint8)
    fm = ft.FmIndex.load(blob, position=case["position"], block=getattr(ft, case["block"]),
                         encoder_kind=case["encoder"])
    cfg = dict(case=case, text=text, source=source, fm=fm, sa_path=sa_path, cpu_answers={})
    cfg["batches"] = _batches(cfg)
    cfg["oracle"] = {name: ([fm.count(p) for p in pats], [sorted(fm.locate(p)) for p in pats])
                     for name, (_, _, pats) in cfg["batches"].items()}
    if source == "corpus":
        qs = case["queries"]
        assert cfg["oracle"]["manifest"] == ([q["count"] for q in qs],
                                             [q["locations"] for q in qs])
    built[cfg_id] = cfg
    return cfg


def _variant_kwargs(cfg: dict, wide: bool, variant: str, tmp_path) -> dict:
    if variant in COMBOS:
        kw = dict(COMBOS[variant])
        if "sa_full" in kw and kw["sa_full"] is None:
            kw["sa_full"] = np.fromfile(cfg["sa_path"], dtype="<u4")
        return kw
    kw = dict((WIDE_VARIANTS if wide else NARROW_VARIANTS)[variant][0])
    fm = cfg["fm"]
    sigma, k = fm.symbol_count, fm.kmer_size
    if variant == "sa_device":  # a dense table of k+3 symbols, k+1 of them from the host
        kw.update(dense_lut_entries=sigma ** (k + 3), dense_host_entries=sigma ** (k + 1))
    elif variant == "sa_array":
        kw["sa_full"] = np.fromfile(cfg["sa_path"], dtype="<u4")
    elif variant == "sa_file":
        kw["sa_full"] = cfg["sa_path"]
    elif variant == "cached":
        kw["dense_lut_cache"] = str(tmp_path / "dense.npz")
    if wide:
        kw["force_wide"] = True
    return kw


def _expected_modes(fm, wide: bool, kw: dict) -> set:
    """The join modes a case launches: rank on every stream call, decode in
    the SA fill, segmented when wide, and there decode in the walk (sampled
    SA, r > 1); a narrow walk is the walk's own kernel (:func:`_walks`)."""
    if not kw.get("stream", True):
        return set()
    sa = kw.get("sa_full")
    if wide:
        return {"rank_seg"} | ({"decode_seg"} if fm.sampling_ratio > 1 else set())
    return {"rank"} | ({"decode"} if isinstance(sa, str) and sa == "device" else set())


def _walks(wide: bool, kw: dict) -> bool:
    """Whether a case's locate calls launch the LF walk's kernel: a narrow
    upload with no full SA, whatever its sampling ratio and engine."""
    return not wide and kw.get("sa_full") is None


# ----------------------------------------------------------------------
# checks
# ----------------------------------------------------------------------

STATE = ("fused", "stream_tbl", "pair_tbl", "sa", "dense_lo", "dense_hi", "pair_c2",
         "pair_fix", "seg_base", "kmer_tbl", "count_arr", "enc_table")


def assert_same_state(card, cpu) -> None:
    assert card.meta == cpu.meta
    assert card.sentinel == cpu.sentinel and card.passthrough == cpu.passthrough
    for name in STATE:
        a, b = getattr(card, name), getattr(cpu, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.device.type == "cuda" and b.device.type == "cpu", name
            assert torch.equal(a.cpu(), b), name


def answers(dev, pats, lens, use_stream: bool, with_count: bool) -> tuple:
    """The query calls on one batch: pos_ranges, locate_with_counts
    (capacity from the counts), resolve_rows at capacity B + 1, which drops
    every occurrence past one overflow slot, and (``with_count``) count,
    else the counts of locate_with_counts once more."""
    lo, hi = dev.pos_ranges(pats, lens, use_stream=use_stream)
    located = dev.locate_with_counts(pats, lens, use_stream=use_stream)
    counts = dev.count(pats, lens, use_stream=use_stream) if with_count else located[3]
    tight = dev.resolve_rows(lo, hi, counts.shape[0] + 1, use_stream)
    return (lo, hi, counts, *located, *tight)


def location_lists(locs, pids, valid, B: int) -> list:
    out = [[] for _ in range(B)]
    for loc, p in zip(locs[valid].tolist(), pids[valid].tolist()):
        out[p].append(loc)
    return [sorted(x) for x in out]


def assert_oracle(got: tuple, want_counts: list, want_locs: list) -> None:
    lo, hi, counts, locs, pids, valid, counts2, dropped, t_locs, t_pids, t_valid, t_dropped = (
        t.cpu() for t in got)
    B = len(want_counts)
    assert counts.tolist() == want_counts and counts2.tolist() == want_counts
    assert (hi - lo).tolist() == want_counts
    assert int(dropped[0]) == 0
    assert location_lists(locs, pids, valid, B) == want_locs
    extra = sum(max(c - 1, 0) for c in want_counts)
    assert t_locs.shape[0] == B + 1
    assert int(t_dropped[0]) == extra - min(extra, 1)
    assert int(t_valid.sum()) == sum(c >= 1 for c in want_counts) + min(extra, 1)
    for loc, p in zip(t_locs[t_valid].tolist(), t_pids[t_valid].tolist()):
        assert loc in want_locs[p]


def cpu_answers(cfg: dict, cpu, dense_host, name: str, use_stream: bool) -> tuple:
    """The CPU's answers to one batch on one engine, one run per distinct
    ``meta`` (engine, seed depth, tables, SA form) and host seed depth
    (``dense_host``: the ``dense_host_entries`` of the upload): options that
    upload the same (a given SA array or file, the dense cache) answer the
    same tensors, so one CPU run serves them.  ``cpu``: this case's CPU
    upload, run if none of its kind has been."""
    # the seed's host depth sets where empty ranges sit
    key = cpu.meta, dense_host, name, use_stream
    if key not in cfg["cpu_answers"]:
        pats, lens, _ = cfg["batches"][name]
        cfg["cpu_answers"][key] = answers(cpu, pats, lens, use_stream, name == "mixed")
    return cfg["cpu_answers"][key]


def upload_pair(fm, kw: dict, card):
    """The same upload on the CPU and on the card with no device named."""
    cpu = ft.to_device_torch(fm, "cpu", **kw)
    dev = ft.to_device_torch(fm, **kw)
    assert dev.device == card
    return dev, cpu


@pytest.mark.cuda
@pytest.mark.parametrize("cfg_id,wide,variant", PARAMS)
def test_card_matches_cpu_and_oracle(cuda, cfg_id, wide, variant, tmp_path, monkeypatch, built):
    cfg = _config(cfg_id, built)
    fm = cfg["fm"]
    kw = _variant_kwargs(cfg, wide, variant, tmp_path)
    if wide:  # 2-64 blocks a segment: the table spans several
        rows = sj.stream_rows(fm.text_len)
        monkeypatch.setattr(sj, "SEG_BLOCKS", 1 << max(0, (rows // 4).bit_length() - 1))
    before = collections.Counter(sj.LAUNCHES)
    walks_before = locate_ops.LAUNCHES["walk"]
    card, cpu = upload_pair(fm, kw, cuda)
    assert_same_state(card, cpu)
    if variant == "cached":
        # a second upload reads the dense cache: building it again raises,
        # as does assembling a fused table on the host
        assert os.path.exists(kw["dense_lut_cache"]) == bool(card.meta.dense_k)

        def refuse(*a, **k):
            raise AssertionError("the cache was not read")

        monkeypatch.setattr(DI, "narrow_fused_rows", refuse)
        monkeypatch.setattr(DI.dense_ops, "dense_lut", refuse)
        assert_same_state(ft.to_device_torch(fm, **kw), cpu)
    names = [n for n in cfg["batches"]
             if (variant not in BUILT_ALIKE or n in ("mixed", "manifest"))
             and (n != "u21" or card.pair_tbl is not None)]  # u21: the pair chain's odd pass
    # without a stream table both engines are the gather engine: asked once
    engines = (True, False) if card.stream_tbl is not None else (True,)
    for name in names:
        pats, lens, _ = cfg["batches"][name]
        for use_stream in engines:
            ref = cpu_answers(cfg, cpu, kw.get("dense_host_entries"), name, use_stream)
            got = answers(card, pats, lens, use_stream, name == "mixed")
            for g, w in zip(got, ref):
                assert g.device.type == "cuda"
                assert torch.equal(g.cpu(), w), (name, use_stream)
            assert_oracle(got, *cfg["oracle"][name])
    if card.stream_tbl is None:
        assert card.engine_for(BATCH_B, use_stream=True) in ("gather", "wide-gather")
    torch.cuda.synchronize()
    launched = collections.Counter(sj.LAUNCHES) - before
    assert set(launched) == _expected_modes(fm, wide, kw), dict(launched)
    assert (locate_ops.LAUNCHES["walk"] > walks_before) == _walks(wide, kw)


def test_matrix_covers_every_case_and_upload_option():
    """Every corpus case is a configuration of the matrix, from its blob and
    from a seeded text, narrow and wide; the seeded text takes every
    variant that applies at its sigma; every keyword of ``from_host`` is set
    by a variant, so an option added later cannot miss the card."""
    ids = {p.id for p in PARAMS}
    for name, case in CASES.items():
        for src in SOURCES:
            for shape in ("narrow", "wide"):
                assert f"{src}-{name}-{shape}-default" in ids
        for shape, variants in (("narrow", NARROW_VARIANTS), ("wide", WIDE_VARIANTS)):
            for v, (_, applies) in variants.items():
                assert (f"seeded-{name}-{shape}-{v}" in ids) == applies(case["symbol_count"])
    keywords = set(inspect.signature(DI.DeviceFmIndex.from_host).parameters) - {"fm", "device"}
    set_by_variants = {k for v in (*NARROW_VARIANTS.values(), *WIDE_VARIANTS.values())
                       for k in v[0]} | {"force_wide"}
    assert keywords == set_by_variants
    # every narrow variant runs at some sigma of the corpus, every wide one at all
    sigmas = {c["symbol_count"] for c in CASES.values()}
    for name, (_, applies) in NARROW_VARIANTS.items():
        assert any(applies(s) for s in sigmas), name
    # every combination of options on both of its configurations, whose
    # alphabets have pair tables; each sets keywords of ``from_host``
    for cfg in COMBO_CONFIGS:
        assert CASES[cfg.split("-", 1)[1]]["symbol_count"] ** 2 <= sj.MAX_SIGMA
        for name, kw in COMBOS.items():
            assert f"{cfg}-narrow-{name}" in ids and set(kw) <= keywords
