"""Port parity: rank primitives (sview_fmindex_tpu_torch/ops/rank.py).

The same positions and symbols, made from a seeded numpy generator, go
through the port, the JAX package's ``ops.rank`` and the host oracle
(``FmIndex._rank_next`` / ``_pre_rank_and_symidx``).  Everything is integer,
so the tolerance is exact equality.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import sview_fmindex_tpu as fmx  # noqa: E402
from sview_fmindex_tpu.ops import rank as jrank  # noqa: E402
from sview_fmindex_tpu_torch import to_device_torch  # noqa: E402
from sview_fmindex_tpu_torch.models.device_index import narrow_fused_rows  # noqa: E402
from sview_fmindex_tpu_torch.ops import rank as trank  # noqa: E402


def _fm(n, block, seed):
    rng = np.random.default_rng(seed)
    text = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n))
    enc = fmx.EncodingTable.from_symbols([b"A", b"C", b"G", b"T"])
    b = fmx.FmIndexBuilder(
        n, 4, enc, position="u32", block=block,
        suffix_array_config=fmx.SuffixArrayConfig.compressed(2),
        lookup_table_config=fmx.LookupTableConfig.kmer_size(3), sa_backend="numpy")
    return fmx.FmIndex.load(np.frombuffer(b.build(text), np.uint8), position="u32",
                            block=block), rng


BLOCKS = [(fmx.BLOCK2_U32, 2001), (fmx.BLOCK3_U64, 3003), (fmx.BLOCK3_U128, 4096)]


@pytest.mark.parametrize("block,n", BLOCKS)
def test_fused_and_derived_checkpoints_match_jax(block, n):
    """The uploaded fused table (checkpoints derived on the device from the
    plane columns) and the host-assembled one (``narrow_fused_rows``, which
    range-sharded staging uses) equal the JAX one, including the final
    partial block's zero padding (which must not count as symbol 0)."""
    fm, _ = _fm(n, block, n)
    jdev = fm.to_device(dense_lut_entries=0, stream=False)  # host-assembled on the CPU
    tdev = to_device_torch(fm, "cpu", dense_lut_entries=0, stream=False)
    want = np.asarray(jdev.fused).view(np.int32)
    np.testing.assert_array_equal(tdev.fused.numpy(), want)
    host = narrow_fused_rows(fm, tdev.meta.num_planes)
    np.testing.assert_array_equal(host.view(np.int32), want)


@pytest.mark.parametrize("block,n", BLOCKS)
def test_rank_next_and_decode_match_jax_and_host(block, n):
    fm, rng = _fm(n, block, n + 1)
    jdev = fm.to_device(dense_lut_entries=0, stream=False)
    tdev = to_device_torch(fm, "cpu", dense_lut_entries=0, stream=False)
    s = fm.sentinel_index
    # every edge: 0, the sentinel row and its neighbours, block borders, n
    edges = [0, 1, s - 2, s - 1, s, s + 1, n - 1, n, 63, 64, 127, 128, 129]
    pos = np.concatenate([[p for p in edges if 0 <= p <= n],
                          rng.integers(0, n + 1, size=600)]).astype(np.int64)
    sym = rng.integers(0, 4, size=pos.shape[0]).astype(np.int64)

    got = trank.rank_next(tdev.meta, tdev.fused, s, torch.from_numpy(pos),
                          torch.from_numpy(sym)).numpy()
    want = np.asarray(jrank.rank_next(jdev.meta, jdev.fused, jdev.sentinel,
                                      jnp.asarray(pos, jnp.uint32),
                                      jnp.asarray(sym, jnp.int32)))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    for i in range(0, pos.shape[0], 7):
        assert got[i] == fm._rank_next(int(pos[i]), int(sym[i])), i

    pos_d = pos[pos < n]
    g_rank, g_sym, g_sent = (t.numpy() for t in trank.pre_rank_and_symidx(
        tdev.meta, tdev.fused, s, torch.from_numpy(pos_d)))
    w_rank, w_sym, w_sent = (np.asarray(a) for a in jrank.pre_rank_and_symidx(
        jdev.meta, jdev.fused, jdev.sentinel, jnp.asarray(pos_d, jnp.uint32)))
    np.testing.assert_array_equal(g_sent, w_sent)
    keep = ~w_sent
    np.testing.assert_array_equal(g_rank[keep], w_rank[keep].astype(np.int64))
    np.testing.assert_array_equal(g_sym[keep], w_sym[keep].astype(np.int64))
    for i in range(pos_d.shape[0]):
        host = fm._pre_rank_and_symidx(int(pos_d[i]))
        assert (host is None) == bool(g_sent[i]), i
        if host is not None:
            assert (g_rank[i], g_sym[i]) == host, i


def test_popcount_and_u32_round_trip():
    rng = np.random.default_rng(5)
    vals = np.concatenate([[0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF],
                           rng.integers(0, 2**32, size=500)]).astype(np.int64)
    got = trank.popcount32(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, [bin(int(v)).count("1") for v in vals])
    as_i32 = trank.to_i32(torch.from_numpy(vals))
    assert as_i32.dtype == torch.int32
    np.testing.assert_array_equal(as_i32.numpy(), vals.astype(np.uint32).view(np.int32))
    np.testing.assert_array_equal(trank.u32(as_i32).numpy(), vals)
