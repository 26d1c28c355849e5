"""The port's own host layer against the JAX package's, on one blob format.

``sview_fmindex_tpu_torch`` keeps a copy of the host modules (config,
encoders, blob, the build passes with the native SA-IS extension, the
builder, the host ``FmIndex``, the host dense seed table) and imports nothing
of ``sview_fmindex_tpu``.  Here the two are held against each other:

- the port's builder writes blobs BYTE-IDENTICAL to the JAX package's, for
  every interop corpus configuration (and to the committed corpus files) and
  for seeded random texts over DNA, wildcard DNA, protein and pass-through
  alphabets, u32 and u64 positions, both suffix-array backends,
- the port's ``FmIndex`` loads every corpus blob and agrees with the JAX
  package's ``FmIndex``, the manifest and the brute-force oracle on count
  and locate,
- ``dense_lut`` / ``auto_dense_k`` are equal,
- a fresh process that imports the port, builds, uploads to the CPU and
  queries ends with neither ``jax`` nor ``sview_fmindex_tpu`` loaded,
- with no device named, the upload entry points raise where there is no
  CUDA device and never land on the CPU.
"""
import base64
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import sview_fmindex_tpu as fmx  # noqa: E402
import sview_fmindex_tpu_torch as ft  # noqa: E402
from sview_fmindex_tpu.build import dense_lut as jdense  # noqa: E402
from sview_fmindex_tpu_torch.build import dense_lut as tdense  # noqa: E402
from sview_fmindex_tpu_torch.native import build_native, loader  # noqa: E402

from oracle import brute_force_locate, gen_rand_pattern, gen_rand_symbols, gen_rand_text  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "interop", "corpus")

with open(os.path.join(CORPUS, "corpus.json")) as _f:
    CASES = json.load(_f)["cases"]
CASE_PARAMS = [pytest.param(c, id=c["name"]) for c in CASES]


def _encoder(pkg, case):
    if case["encoder"] == "pass":
        return pkg.PassThrough()
    symbols = [base64.b64decode(s) for s in case["symbols"]]
    if case["wildcard_reserved"]:
        return pkg.EncodingTable.from_symbols_with_wildcard(symbols)
    return pkg.EncodingTable.from_symbols(symbols)


def _build(pkg, text, sigma, enc, position, block, k, r, **kw):
    b = pkg.FmIndexBuilder(
        len(text), sigma, enc, position=position, block=getattr(pkg, block),
        suffix_array_config=(pkg.SuffixArrayConfig.compressed(r) if r > 1
                             else pkg.SuffixArrayConfig.uncompressed()),
        lookup_table_config=(pkg.LookupTableConfig.kmer_size(k) if k > 1
                             else pkg.LookupTableConfig.none()), **kw)
    return b.build(text)


def _load(pkg, blob, case):
    return pkg.FmIndex.load(np.frombuffer(bytes(blob), np.uint8), position=case["position"],
                            block=getattr(pkg, case["block"]), encoder_kind=case["encoder"])


# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", CASE_PARAMS)
def test_corpus_blob_byte_identical(case):
    """Rebuilt from the manifest's text, the port's blob equals the JAX
    package's and the committed file, byte for byte."""
    text = base64.b64decode(case["text"])
    args = (case["symbol_count"], None, case["position"], case["block"],
            case["kmer_size_config"], case["sampling_ratio_config"])
    blobs = []
    for pkg in (ft, fmx):
        a = list(args)
        a[1] = _encoder(pkg, case)
        blobs.append(bytes(_build(pkg, text, *a)))
    with open(os.path.join(CORPUS, case["blob"]), "rb") as f:
        committed = f.read()
    assert blobs[0] == blobs[1]
    assert blobs[0] == committed


# (id, alphabet spec, position, block, k, r, suffix-array backend)
RANDOM_CASES = [
    ("dna_u32_native", ("table", [b"Aa", b"Cc", b"Gg", b"Tt"]), "u32", "BLOCK3_U64", 3, 4, "native"),
    ("dna_u32_numpy", ("table", [b"A", b"C", b"G", b"T"]), "u32", "BLOCK2_U64", 4, 2, "numpy"),
    ("dna_u64", ("table", [b"A", b"C", b"G", b"T"]), "u64", "BLOCK3_U64", 3, 2, "native"),
    ("dna_u64_r1", ("table", [b"A", b"C", b"G", b"T"]), "u64", "BLOCK2_U128", 1, 1, "numpy"),
    ("wildcard", ("wild", [b"A", b"C", b"G", b"T"]), "u32", "BLOCK3_U64", 2, 3, "native"),
    ("protein", ("table", [bytes([c]) for c in b"ARNDCQEGHILKMFPSTWYV"]), "u32",
     "BLOCK5_U64", 2, 2, "native"),
    ("protein_u64", ("table", [bytes([c]) for c in b"ARNDCQEGHILKMFPSTWYV"]), "u64",
     "BLOCK5_U64", 2, 5, None),
    ("passthrough", ("pass", 9), "u32", "BLOCK4_U32", 2, 2, "native"),
    ("passthrough_u64", ("pass", 40), "u64", "BLOCK6_U64", 2, 2, "numpy"),
]


def _random_text(spec, seed):
    rng = np.random.default_rng(seed)
    kind, arg = spec
    n = int(rng.integers(3000, 6000))
    if kind == "pass":
        return bytes(range(arg)) + rng.integers(0, arg, n, dtype=np.uint8).tobytes()
    alphabet = np.frombuffer(b"".join(arg), np.uint8)
    text = bytearray(b"".join(arg) + rng.choice(alphabet, n).tobytes())
    if kind == "wild":
        for i in rng.integers(0, len(text), 40):
            text[i] = ord("#")
    return bytes(text)


def _random_encoder(pkg, spec):
    kind, arg = spec
    if kind == "pass":
        return pkg.PassThrough(), arg
    enc = (pkg.EncodingTable.from_symbols_with_wildcard(arg) if kind == "wild"
           else pkg.EncodingTable.from_symbols(arg))
    return enc, enc.symbol_count()


@pytest.fixture(scope="module")
def jax_native_sais():
    """The JAX package's SA-IS library, loadable before its first use here.

    Its loader has g++ write straight to ``libsview_native.so``: a test
    worker that loads the file while another worker is still writing it
    fails, and the loader keeps that failure for the rest of its process.
    Where the library is missing or did not load, it is compiled with the
    package's own flags into a temporary file beside it, published whole by
    ``os.replace``, and the loader is reset and asked again."""
    from sview_fmindex_tpu.native import build_native as jbuild
    from sview_fmindex_tpu.native import loader as jloader

    out = os.path.join(jbuild.HERE, jbuild.OUTPUT)
    if os.path.exists(out) and jloader._load() is not None:
        return
    tmp = os.path.join(jbuild.HERE, f"libsview_native.{os.getpid()}.tmp.so")  # *.so: ignored
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jbuild, "OUTPUT", os.path.basename(tmp))
            os.replace(jbuild.build(verbose=False), out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    jloader._lib, jloader._load_failed = None, False
    if jloader._load() is None:
        pytest.fail(f"the JAX package's native SA-IS library {out} does not load")


@pytest.mark.parametrize("name,spec,position,block,k,r,backend", RANDOM_CASES,
                         ids=[c[0] for c in RANDOM_CASES])
def test_random_blob_byte_identical(name, spec, position, block, k, r, backend, tmp_path,
                                    jax_native_sais):
    """Seeded random texts: the two builders' blobs and their full-SA side
    files are byte-identical, with either suffix-array backend."""
    if backend in ("native", None):
        assert loader.available()  # g++ builds the port's own library at first use
    text = _random_text(spec, seed=len(name) * 7919 + k * 31 + r)
    out = []
    for tag, pkg in (("t", ft), ("j", fmx)):
        enc, sigma = _random_encoder(pkg, spec)
        b = pkg.FmIndexBuilder(
            len(text), sigma, enc, position=position, block=getattr(pkg, block),
            suffix_array_config=(pkg.SuffixArrayConfig.compressed(r) if r > 1
                                 else pkg.SuffixArrayConfig.uncompressed()),
            lookup_table_config=(pkg.LookupTableConfig.kmer_size(k) if k > 1
                                 else pkg.LookupTableConfig.none()),
            sa_backend=backend)
        assert b.blob_size() > 0
        sa_path = str(tmp_path / f"sa_{tag}.bin") if position == "u32" else None
        blob = bytes(b.build(text, sa_full_path=sa_path))
        assert len(blob) == b.blob_size()
        out.append((blob, open(sa_path, "rb").read() if sa_path else b""))
    assert out[0][0] == out[1][0]
    assert out[0][1] == out[1][1]


def test_native_library_builds_into_the_ports_build_dir():
    """The port's SA-IS library is written under its own ``_build/``, never
    beside the sources or into the JAX package, and equals the numpy backend."""
    assert loader.available()
    path = build_native.output_path()
    pkg_dir = os.path.dirname(os.path.abspath(ft.__file__))
    assert os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(pkg_dir, "_build")
    assert not [f for f in os.listdir(os.path.join(pkg_dir, "native")) if f.endswith(".so")]
    from sview_fmindex_tpu_torch.build import suffix_array as tsa

    rng = np.random.default_rng(5)
    s = np.concatenate([rng.integers(1, 5, 4000), [0]]).astype(np.uint8)
    np.testing.assert_array_equal(tsa.suffix_array(s, "native"), tsa.suffix_array(s, "numpy"))


# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", CASE_PARAMS)
def test_port_index_answers_corpus(case):
    """The port's FmIndex on a committed blob: count and locate equal the
    JAX package's FmIndex, the manifest and brute force over the encoded
    text."""
    with open(os.path.join(CORPUS, case["blob"]), "rb") as f:
        blob = f.read()
    tfm, jfm = _load(ft, blob, case), _load(fmx, blob, case)
    assert type(tfm).__module__.startswith("sview_fmindex_tpu_torch.")
    for name in ("text_len", "symbol_count", "kmer_size", "sampling_ratio", "sentinel_index"):
        assert getattr(tfm, name) == getattr(jfm, name), name
    for name in ("count_array", "kmer_count_table", "suffix_array", "rank_checkpoints", "lanes"):
        np.testing.assert_array_equal(getattr(tfm, name), getattr(jfm, name))
    text = np.frombuffer(base64.b64decode(case["text"]), np.uint8)
    text_sym = tfm.encoder.encode(text)
    np.testing.assert_array_equal(text_sym, jfm.encoder.encode(text))
    for q in case["queries"]:
        pat = base64.b64decode(q["pattern"])
        expected = brute_force_locate(text_sym, tfm.encoder.encode(np.frombuffer(pat, np.uint8)))
        assert tfm.count(pat) == jfm.count(pat) == q["count"] == len(expected)
        got = sorted(int(x) for x in tfm.locate(pat))
        assert got == sorted(int(x) for x in jfm.locate(pat)) == q["locations"] == expected


def test_port_index_random_text_matches_oracle():
    """A random alphabet and text through the port's builder and FmIndex
    alone, against brute force (the oracle the JAX package is held to)."""
    rng = random.Random(77)
    symbols = gen_rand_symbols(rng, 7)
    text = gen_rand_text(rng, symbols, 400, 600)
    enc = ft.EncodingTable.from_symbols(symbols)
    blob = _build(ft, text, enc.symbol_count(), enc, "u32", "BLOCK3_U64", 3, 2)
    fm = ft.FmIndex.load(blob, block=ft.BLOCK3_U64)
    text_sym = enc.encode(np.frombuffer(text, np.uint8))
    for _ in range(40):
        pat = gen_rand_pattern(rng, text, 1, 10)
        expected = brute_force_locate(text_sym, enc.encode(np.frombuffer(pat, np.uint8)))
        assert fm.count(pat) == len(expected)
        assert sorted(int(x) for x in fm.locate(pat)) == expected


def test_empty_pattern_is_the_one_input_the_host_classes_differ_on():
    """The two host classes give equal answers on every input but the empty
    pattern: the JAX package's class returns minus the text length (a
    negative index wraps; recorded as a fault of the reference, left alone),
    the port's returns 0, as both device classes do."""
    case = CASES[1]
    with open(os.path.join(CORPUS, case["blob"]), "rb") as f:
        blob = f.read()
    tfm, jfm = _load(ft, blob, case), _load(fmx, blob, case)
    assert jfm.count(b"") == -jfm.text_len
    assert tfm.count(b"") == 0
    assert tfm.locate(b"") == [] == jfm.locate(b"")
    rng = np.random.default_rng(8)
    text = base64.b64decode(case["text"])
    for _ in range(30):  # every other input: equal
        n = int(rng.integers(1, 9))
        s = int(rng.integers(0, len(text) - n))
        pat = text[s:s + n]
        assert tfm.count(pat) == jfm.count(pat) and tfm.locate(pat) == jfm.locate(pat)


def test_load_errors_are_the_ports_own():
    blob = np.fromfile(os.path.join(CORPUS, CASES[0]["blob"]), np.uint8)
    with pytest.raises(ft.LoadError):
        ft.FmIndex.load(blob[:-8], position="u32", block=ft.BLOCK2_U64)
    with pytest.raises(ft.BuildError):
        ft.FmIndexBuilder(10, 9, ft.PassThrough(), block=ft.BLOCK2_U64)
    assert ft.LoadError is not fmx.LoadError and ft.BuildError is not fmx.BuildError


# ----------------------------------------------------------------------
@pytest.mark.parametrize("case,dk,wide", [
    pytest.param(CASES[1], 5, False, id="dna_dk5"),
    pytest.param(CASES[1], 3, False, id="dna_dk_eq_k"),
    pytest.param(CASES[5], 4, False, id="wildcard_dk4"),
    pytest.param(CASES[6], 3, False, id="protein_dk3"),
    pytest.param(CASES[9], 6, True, id="dna_u64_dk6_wide"),
])
def test_dense_lut_equal(case, dk, wide):
    with open(os.path.join(CORPUS, case["blob"]), "rb") as f:
        blob = f.read()
    tfm, jfm = _load(ft, blob, case), _load(fmx, blob, case)
    t_lo, t_hi = tdense.dense_lut(tfm, dk, chunk=1000, wide=wide)
    j_lo, j_hi = jdense.dense_lut(jfm, dk, wide=wide)
    assert t_lo.dtype == j_lo.dtype
    np.testing.assert_array_equal(t_lo, j_lo)
    np.testing.assert_array_equal(t_hi, j_hi)
    # the port's table from a JAX-package FmIndex too: it reads the views only
    np.testing.assert_array_equal(tdense.dense_lut(jfm, dk, wide=wide)[1], j_hi)


def test_auto_dense_k_equal():
    for sigma in (2, 4, 5, 20, 40):
        for k in (1, 2, 3, 5):
            for entries in (0, 1, 1 << 10, 1 << 20, 1 << 26):
                for n in (None, 100, 10**6, 10**9):
                    assert tdense.auto_dense_k(sigma, k, entries, text_len=n) == \
                        jdense.auto_dense_k(sigma, k, entries, text_len=n)


# ----------------------------------------------------------------------
_STANDALONE = r"""
import sys
import numpy as np
import sview_fmindex_tpu_torch as ft

rng = np.random.default_rng(3)
text = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=20000).tobytes()
enc = ft.EncodingTable.from_symbols([b"A", b"C", b"G", b"T"])
b = ft.FmIndexBuilder(len(text), 4, enc, position="u32", block=ft.BLOCK3_U64,
                      suffix_array_config=ft.SuffixArrayConfig.compressed(4),
                      lookup_table_config=ft.LookupTableConfig.kmer_size(3))
fm = ft.FmIndex.load(b.build(text), position="u32", block=ft.BLOCK3_U64)
pats = [text[s:s + 12] for s in rng.integers(0, len(text) - 12, 50)]
batch, lens = ft.pack_patterns(pats)
for dev in (fm.to_device("cpu", sa_full="device"), ft.to_device_torch(fm, "cpu")):
    for use_stream in (True, False):
        counts = dev.count(batch, lens, use_stream=use_stream)
        assert counts.tolist() == [fm.count(p) for p in pats]
        locs, pids, valid, dropped = dev.locate(batch, lens, use_stream=use_stream)
        assert int(dropped[0]) == 0
        for i, p in enumerate(pats):
            assert sorted(locs[valid & (pids == i)].tolist()) == sorted(int(x) for x in fm.locate(p))
from sview_fmindex_tpu_torch.parallel import distributed, mesh, query, range_shard  # noqa: F401
# the bench surfaces: the package's modules, then the scripts beside it
import importlib.util, os
from sview_fmindex_tpu_torch.bench import cli, micro, scaling, timing  # noqa: F401
import sview_fmindex_tpu_torch.bench.join_cases, sview_fmindex_tpu_torch.bench.sharded_overhead  # noqa: F401
repo = os.environ["SVIEW_REPO"]
for rel in ("bench_torch.py", "run_benchmark_torch.py", os.path.join("tools", "torch_wide_bench.py")):
    spec = importlib.util.spec_from_file_location(rel[:-3].replace(os.sep, "_"), os.path.join(repo, rel))
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "sview_fmindex_tpu" or m.startswith("sview_fmindex_tpu.") or m == "bench"]
assert not bad, bad
assert "bench_torch" in sys.modules  # the two scripts share the headline bench's inputs
print("STANDALONE_OK")
"""


def test_port_stands_alone_in_a_fresh_process(tmp_path):
    """Import, build, upload to the CPU, query, then import every bench
    surface (the package's and the scripts at the root and under ``tools/``):
    neither ``jax`` nor ``sview_fmindex_tpu`` nor ``bench`` is loaded at the
    end."""
    script = tmp_path / "standalone.py"
    script.write_text(_STANDALONE)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", SVIEW_REPO=REPO)
    proc = subprocess.run([sys.executable, str(script)], env=env, cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "STANDALONE_OK" in proc.stdout


def test_port_sources_import_nothing_of_jax():
    """No module of the port (nor ``chip_smoke.py``) names ``jax`` or the JAX
    package in an import statement."""
    import re

    pat = re.compile(r"^\s*(from|import)\s+(sview_fmindex_tpu(\.|\s|$)|jax(\.|\s|$)|bench(\.|\s|$))")
    files = [os.path.join(REPO, rel) for rel in (
        "chip_smoke.py", "bench_torch.py", "run_benchmark_torch.py",
        os.path.join("tools", "torch_wide_bench.py"))]
    for root, _, names in os.walk(os.path.join(REPO, "sview_fmindex_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            hits = [line for line in f if pat.match(line)]
        assert not hits, (path, hits)


def test_default_device_raises_without_cuda(monkeypatch):
    """No device named: the card, and an error where there is none; the CPU
    only by name."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    case = CASES[1]
    with open(os.path.join(CORPUS, case["blob"]), "rb") as f:
        fm = _load(ft, f.read(), case)
    for call in (lambda: fm.to_device(),
                 lambda: ft.to_device_torch(fm),
                 lambda: ft.DeviceFmIndex.from_host(fm),
                 lambda: ft.to_device_torch(fm, None, force_wide=True)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    dev = fm.to_device("cpu")
    assert dev.device.type == "cpu"
    arrays = {f: (getattr(dev, f).numpy() if isinstance(getattr(dev, f), torch.Tensor)
                  else np.asarray(getattr(dev, f)))
              for f in ("count_arr",)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ft.DeviceFmIndex.from_reference(arrays, dev.meta)
    from sview_fmindex_tpu_torch.parallel import distributed

    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize("localhost:1", 1, 0)
    assert not torch.distributed.is_initialized()
