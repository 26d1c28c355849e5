"""Port parity, the slice end to end (sview_fmindex_tpu_torch/models/device_index.py).

One blob and one set of pattern batches (made from seeded numpy generators)
go through the port, the JAX ``DeviceFmIndex`` and the host oracle
(``FmIndex.count``/``locate``): uniform lengths with dense seeds and even
and odd step counts (the sorted pair chain with and without its sigma=4
pass), mixed lengths (the pair loop), patterns shorter than k, wildcard
bytes, both engines, and state carried over from the JAX index.  Without a
full SA the LF walk decodes through the join (stream) or by gathers.  Counts
and located positions must be exactly equal.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import sview_fmindex_tpu as fmx  # noqa: E402
from sview_fmindex_tpu.utils.patterns import pack_patterns  # noqa: E402
from sview_fmindex_tpu_torch import BuildError, DeviceFmIndex, to_device_torch  # noqa: E402
from sview_fmindex_tpu_torch.models import device_index as DI  # noqa: E402
from sview_fmindex_tpu_torch.ops import stream_join as tsj  # noqa: E402

N = 4201  # sigma**7 <= 4*N, so dense_k reaches 7
DENSE = dict(dense_lut_entries=4 ** 7, dense_host_entries=4 ** 5)  # dk 7: 5 host + 2 device


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(2024)
    text = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=N))
    # lower-case bytes map to their symbols; every other byte is the wildcard
    enc = fmx.EncodingTable.from_symbols([b"Aa", b"Cc", b"Gg", b"Tt"])
    b = fmx.FmIndexBuilder(
        N, 4, enc, position="u32", block=fmx.BLOCK3_U64,
        suffix_array_config=fmx.SuffixArrayConfig.compressed(2),
        lookup_table_config=fmx.LookupTableConfig.kmer_size(3), sa_backend="numpy")
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "sa.u32")
        blob = b.build(text, sa_full_path=p)
        sa_full = np.fromfile(p, dtype="<u4")
    fm = fmx.FmIndex.load(np.frombuffer(blob, np.uint8), position="u32",
                          block=fmx.BLOCK3_U64)
    jdev = fm.to_device(sa_full="device", stream_tile=256, **DENSE)
    tdev = to_device_torch(fm, "cpu", sa_full="device", **DENSE)
    return dict(text=text, fm=fm, jdev=jdev, tdev=tdev, sa_full=sa_full)


def _batch(text, rng, lens):
    starts = rng.integers(0, len(text) - max(lens), size=len(lens))
    pats = [text[s:s + n] for s, n in zip(starts, lens)]
    return pats, *pack_patterns(pats)


def _assert_same(fm, tdev, jdev, pats, batch, lens, use_stream, use_pair=True):
    c = tdev.count(batch, lens, use_stream=use_stream, use_pair=use_pair).numpy()
    np.testing.assert_array_equal(c, np.asarray(jdev.count(batch, lens)).astype(np.int64))
    np.testing.assert_array_equal(c, [fm.count(p) for p in pats])
    locs, pids, valid, counts, dropped = tdev.locate_with_counts(
        batch, lens, use_stream=use_stream, use_pair=use_pair)
    assert int(dropped[0]) == 0 and torch.equal(counts, torch.from_numpy(c))
    jl, jp, jv, _ = (np.asarray(a) for a in jdev.locate(batch, lens, capacity=locs.shape[0]))
    np.testing.assert_array_equal(valid.numpy(), jv)
    np.testing.assert_array_equal(locs.numpy()[jv], jl[jv].astype(np.int64))
    np.testing.assert_array_equal(pids.numpy()[jv], jp[jv].astype(np.int64))
    for i, p in enumerate(pats):
        assert sorted(locs[valid & (pids == i)].tolist()) == sorted(fm.locate(p)), i


@pytest.mark.parametrize("extra", [4, 5], ids=["even_steps", "odd_steps"])
@pytest.mark.parametrize("use_stream", [True, False])
def test_uniform_dense_batches(index, extra, use_stream):
    t, fm, tdev, jdev = index["text"], index["fm"], index["tdev"], index["jdev"]
    assert tdev.meta.dense_k == jdev.meta.dense_k == 7
    plen = tdev.meta.dense_k + extra
    pats, batch, lens = _batch(t, np.random.default_rng(plen), [plen] * 300)
    pats[3] = b"T" * plen  # absent: an empty range rides the chain
    batch[3] = np.frombuffer(pats[3], np.uint8)
    assert tdev.engine_for(300, use_stream=use_stream) == (
        "pair-stream" if use_stream else "gather")
    _assert_same(fm, tdev, jdev, pats, batch, lens, use_stream)


@pytest.mark.parametrize("use_stream,use_pair", [(True, True), (True, False), (False, True)])
def test_mixed_lengths_short_patterns_and_wildcards(index, use_stream, use_pair):
    t, fm, tdev, jdev = index["text"], index["fm"], index["tdev"], index["jdev"]
    rng = np.random.default_rng(7)
    pats, _, _ = _batch(t, rng, list(rng.integers(1, 16, size=250)))
    # patterns shorter than k=3, and wildcard bytes (== the last symbol)
    pats += [b"A", b"cg", b"T", b"GA", b"ACGTN", b"xx", b"aNNt", b"NNNNNNNNN"]
    batch, lens = pack_patterns(pats)
    _assert_same(fm, tdev, jdev, pats, batch, lens, use_stream, use_pair)


def test_state_from_reference(index):
    """The port answers the same queries from the JAX index's state."""
    t, fm, tdev, jdev = index["text"], index["fm"], index["tdev"], index["jdev"]
    arrays = {f.name: np.asarray(getattr(jdev, f.name))
              for f in dataclasses.fields(jdev) if f.name != "meta"}
    rdev = DeviceFmIndex.from_reference(arrays, jdev.meta, device="cpu")
    for name in ("fused", "stream_tbl", "pair_tbl", "sa", "dense_lo", "dense_hi",
                 "count_arr", "kmer_tbl", "pair_c2", "pair_fix"):
        assert torch.equal(getattr(rdev, name), getattr(tdev, name)), name
    assert rdev.meta == tdev.meta and rdev.sentinel == tdev.sentinel
    for plen in (11, 12, 5):
        pats, batch, lens = _batch(t, np.random.default_rng(plen), [plen] * 200)
        _assert_same(fm, rdev, jdev, pats, batch, lens, use_stream=True)


def test_sa_full_array_memmap_walk_and_stale_guard(index, tmp_path):
    t, fm, jdev = index["text"], index["fm"], index["jdev"]
    pats, batch, lens = _batch(t, np.random.default_rng(1), [9] * 120)
    path = tmp_path / "sa.u32"
    index["sa_full"].tofile(path)
    walk = to_device_torch(fm, "cpu", dense_lut_entries=0)  # sampled SA + LF walk
    assert not walk.meta.has_sa_full
    for dev in (to_device_torch(fm, "cpu", dense_lut_entries=0, sa_full=index["sa_full"]),
                to_device_torch(fm, "cpu", dense_lut_entries=0, sa_full=str(path)), walk):
        _assert_same(fm, dev, jdev, pats, batch, lens, use_stream=True)
    stale = index["sa_full"].copy()
    stale[::2] = stale[::2][::-1]
    with pytest.raises(BuildError, match="stale"):
        to_device_torch(fm, "cpu", sa_full=stale)


def test_upload_options(index, tmp_path):
    fm, tdev = index["fm"], index["tdev"]
    cache = str(tmp_path / "dense.npz")
    # the second upload is served from the dense cache the first wrote
    devs = [to_device_torch(fm, "cpu", dense_lut_cache=cache, **DENSE) for _ in range(2)]
    assert os.path.exists(cache)
    for dev in devs:
        for name in ("fused", "stream_tbl", "pair_tbl", "dense_lo", "dense_hi"):
            assert torch.equal(getattr(dev, name), getattr(tdev, name)), name
    bare = to_device_torch(fm, "cpu", dense_lut_entries=0, stream=False)
    assert bare.meta.stream_rows == bare.meta.pair_rows == 0
    assert bare.engine_for(1 << 20, use_stream=True) == "gather"
    with pytest.warns(RuntimeWarning, match="budget"):
        assert not tdev._stream(tdev.STREAM_MAX_BATCH, True)


def test_cpu_upload_derives_its_tables(index, monkeypatch):
    """A CPU upload is the card's: it copies the plane columns and derives
    the checkpoints, then the stream and pair tables, on the device; no
    fused table is assembled on the host.  Its tables equal the fixture's
    upload and the JAX index's (host-assembled on the CPU) fused table."""
    fm, tdev, jdev = index["fm"], index["tdev"], index["jdev"]

    def refuse(*a, **k):
        raise AssertionError("a fused table was assembled on the host")

    monkeypatch.setattr(DI, "narrow_fused_rows", refuse)
    dev = to_device_torch(fm, "cpu", sa_full="device", **DENSE)
    assert dev.meta == tdev.meta and dev.meta.pair_rows
    for name in ("fused", "stream_tbl", "pair_tbl"):
        assert torch.equal(getattr(dev, name), getattr(tdev, name)), name
    np.testing.assert_array_equal(dev.fused.numpy(), np.asarray(jdev.fused).view(np.int32))


def _spy(monkeypatch, module, name, record):
    """Wrap ``module.name`` so each call appends ``record(*args)``."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        seen.append(record(*args))
        return fn(*args, **kwargs)

    seen = []
    monkeypatch.setattr(module, name, wrapper)
    return seen


def test_stream_decode_walk(index, monkeypatch):
    """No full SA: the walk decodes through the join's decode mode
    (``use_stream``) or by fused-row gathers; both equal the JAX stream walk
    (interpret mode), each other and the oracle."""
    t, fm = index["text"], index["fm"]
    walk = to_device_torch(fm, "cpu", **DENSE)
    jwalk = fm.to_device(stream_tile=256, **DENSE)
    assert not walk.meta.has_sa_full and not jwalk.meta.has_sa_full
    decodes = _spy(monkeypatch, tsj, "join_plain", lambda *a: a[4])
    for plen, ref in ((11, True), (5, False)):  # dense seed + pair chain; blob seed
        pats, batch, lens = _batch(t, np.random.default_rng(plen), [plen] * 150)
        out = {}
        for use_stream in (True, False):
            decodes.clear()
            out[use_stream] = walk.locate_with_counts(batch, lens, use_stream=use_stream)
            assert (True in decodes) == use_stream
            _assert_same(fm, walk, jwalk, pats, batch, lens, use_stream)
        for a, b in zip(out[True], out[False]):
            assert torch.equal(a, b)
        if ref:
            locs, pids, valid, _, _ = out[True]
            jl, jp, jv, jd = (np.asarray(a) for a in jwalk.locate(
                batch, lens, capacity=locs.shape[0], use_stream=True))
            assert int(jd[0]) == 0
            np.testing.assert_array_equal(valid.numpy(), jv)
            np.testing.assert_array_equal(locs.numpy()[jv], jl[jv].astype(np.int64))
            np.testing.assert_array_equal(pids.numpy()[jv], jp[jv].astype(np.int64))


def test_port_imports_no_jax():
    code = ("import sys, sview_fmindex_tpu_torch, sview_fmindex_tpu_torch.kernels, "
            "sview_fmindex_tpu_torch.build.sa_fill, sview_fmindex_tpu_torch.build.pair_table, "
            "sview_fmindex_tpu_torch.ops.wide, sview_fmindex_tpu_torch.bench.timing; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=root)
