"""Port parity: sort-join engine (sview_fmindex_tpu_torch/ops/stream_join.py).

The derived row-major stream table must equal the JAX package's tiled table
after the layout adapter, and the join (its plain version on the CPU; the
CUDA kernel is held against it in ``test_torch_kernels.py``) must equal
JAX's ``rank_next_sorted`` /
``pre_rank_and_symidx_sorted`` (Pallas in interpret mode) at sigma=4 and on
the sigma^2=16 pair table, duplicate keys included.  For wide (u64-position)
indexes the segment-local table and its bases must equal JAX's
``derive_stream_table_wide`` after the adapter, and the segmented join must
equal JAX's ``rank_next_sorted_wide`` / ``pre_rank_and_symidx_sorted_wide``
(the blkkey kernel; its (hi, lo) lanes combined).  Exact equality.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import sview_fmindex_tpu as fmx  # noqa: E402
from sview_fmindex_tpu.models.device_index import DeviceFmIndex as JaxDeviceFmIndex  # noqa: E402
from sview_fmindex_tpu.ops import stream_join as jsj  # noqa: E402
from sview_fmindex_tpu.ops import wide as jwide  # noqa: E402
from sview_fmindex_tpu_torch import to_device_torch  # noqa: E402
from sview_fmindex_tpu_torch.ops import stream_join as tsj  # noqa: E402

T = 256  # reference stream tile: several tiles at these text sizes


def _fm(n, block, seed, position="u32"):
    rng = np.random.default_rng(seed)
    text = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n))
    enc = fmx.EncodingTable.from_symbols([b"A", b"C", b"G", b"T"])
    b = fmx.FmIndexBuilder(
        n, 4, enc, position=position, block=block,
        suffix_array_config=fmx.SuffixArrayConfig.compressed(2),
        lookup_table_config=fmx.LookupTableConfig.kmer_size(3), sa_backend="numpy")
    return fmx.FmIndex.load(np.frombuffer(b.build(text), np.uint8), position=position,
                            block=block), rng


@pytest.mark.parametrize("block,n", [
    (fmx.BLOCK3_U64, 40_003),   # 313 blocks: two reference tiles
    (fmx.BLOCK2_U32, 777),      # BL=32: 4 fused blocks per stream block
    (fmx.BLOCK3_U128, 4096),    # BL=128: n a multiple of the block
])
def test_derived_stream_table_matches_adapted_reference(block, n):
    fm, _ = _fm(n, block, n)
    jdev = fm.to_device(dense_lut_entries=0, stream_tile=T, pair=False)
    tdev = to_device_torch(fm, "cpu", dense_lut_entries=0, pair=False)
    ref = tsj.stream_table_from_reference(np.asarray(jdev.stream_tbl), 4, T)
    assert tdev.stream_tbl.shape == (tsj.stream_rows(n), tsj._rw(4))
    np.testing.assert_array_equal(tdev.stream_tbl.numpy(), ref[:tsj.stream_rows(n)])
    # the reference's padding blocks are all zero
    assert not ref[tsj.stream_rows(n):].any()


@pytest.fixture(scope="module")
def indexes():
    fm, rng = _fm(40_003, fmx.BLOCK3_U64, 17)
    jdev = fm.to_device(dense_lut_entries=0, stream_tile=T)
    tdev = to_device_torch(fm, "cpu", dense_lut_entries=0)
    return fm, jdev, tdev


def _queries(fm, rng, B=700):
    s = fm.sentinel_index
    pos = np.concatenate([[0, s - 1, s, s + 1, fm.text_len, 5, 5, 5],
                          rng.integers(0, fm.text_len + 1, size=B - 8)]).astype(np.int64)
    return pos


@pytest.mark.parametrize("pair", [False, True], ids=["sigma4", "sigma16"])
def test_join_rank_matches_reference(indexes, pair):
    fm, jdev, tdev = indexes
    rng = np.random.default_rng(3 + pair)
    pos = _queries(fm, rng)
    if pair:
        sigma, jtbl, ttbl = 16, jdev.pair_tbl, tdev.pair_tbl
        jmeta = dataclasses.replace(jdev.meta, sigma=16, stream_rows=jdev.meta.pair_rows)
    else:
        sigma, jtbl, ttbl = 4, jdev.stream_tbl, tdev.stream_tbl
        jmeta = jdev.meta
    sym = rng.integers(0, sigma, size=pos.shape[0]).astype(np.int64)
    want = np.asarray(jsj.rank_next_sorted(
        jmeta, jtbl, jdev.sentinel, jnp.asarray(pos, jnp.uint32),
        jnp.asarray(sym, jnp.int32), T=T, C=1024))
    got = tsj.rank_next_sorted(ttbl, tdev.sentinel, torch.from_numpy(pos),
                               torch.from_numpy(sym), sigma)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("pair", [False, True], ids=["sigma4", "sigma16"])
def test_join_decode_matches_reference(indexes, pair):
    fm, jdev, tdev = indexes
    pos = _queries(fm, np.random.default_rng(9 + pair))
    pos = pos[pos < fm.text_len]
    if pair:
        sigma, jtbl, ttbl = 16, jdev.pair_tbl, tdev.pair_tbl
        jmeta = dataclasses.replace(jdev.meta, sigma=16, stream_rows=jdev.meta.pair_rows)
    else:
        sigma, jtbl, ttbl = 4, jdev.stream_tbl, tdev.stream_tbl
        jmeta = jdev.meta
    w_rank, w_sym, w_sent = (np.asarray(a) for a in jsj.pre_rank_and_symidx_sorted(
        jmeta, jtbl, jdev.sentinel, jnp.asarray(pos, jnp.uint32), T=T, C=1024))
    g_rank, g_sym, g_sent = (t.numpy() for t in tsj.pre_rank_and_symidx_sorted(
        ttbl, tdev.sentinel, torch.from_numpy(pos), sigma))
    np.testing.assert_array_equal(g_sent, w_sent)
    keep = ~w_sent
    np.testing.assert_array_equal(g_rank[keep], w_rank[keep].astype(np.int64))
    np.testing.assert_array_equal(g_sym[keep], w_sym[keep].astype(np.int64))


@pytest.mark.parametrize("sigma", [1, 2, 3, 4, 5, 8, 9, 12, 16, 20, 24, 25, 36, 49, 63])
def test_row_layout_never_straddles_a_64_byte_piece_more_than_it_must(sigma):
    """One rule (``_plane_off``) decides the row: 16-byte aligned planes that
    end the row, the checkpoint padded to 4 words and by 4 more where the row
    would be 48 bytes modulo 64; ``_rows`` and the reference adapter follow it."""
    P = max(1, (sigma - 1).bit_length())
    off, rw = tsj._plane_off(sigma), tsj._rw(sigma)
    base = -(-sigma // 4) * 4
    assert rw == off + 4 * P and off % 4 == 0
    assert off == base + (4 if (base + 4 * P) * 4 % 64 == 48 else 0)
    assert rw * 4 % 64 != 48 and rw * 4 - (base + 4 * P) * 4 in (0, 16)
    if sigma in (3, 4):
        assert rw * 4 == 64
    rng = np.random.default_rng(sigma)
    ckpt = rng.integers(0, 2**31, size=(T, sigma)).astype(np.int32)
    planes = rng.integers(-2**31, 2**31, size=(T, 4 * P)).astype(np.int32)
    rows = tsj._rows(torch.from_numpy(ckpt), torch.from_numpy(planes)).numpy()
    assert rows.shape == (T, rw) and not rows[:, sigma:off].any()
    np.testing.assert_array_equal(rows[:, :sigma], ckpt)
    np.testing.assert_array_equal(rows[:, rw - 4 * P:], planes)
    # one reference tile: [RW', T], checkpoints then planes then its own padding
    rw_ref = jsj._layout(sigma, T)[0]
    ref = np.zeros((rw_ref, T), np.int32)
    ref[:sigma] = ckpt.T
    ref[sigma:sigma + 4 * P] = planes.T
    np.testing.assert_array_equal(tsj.stream_table_from_reference(ref, sigma, T), rows)


@pytest.mark.parametrize("pair", [False, True], ids=["sigma4", "sigma16"])
def test_gather_engine_reads_stream_layout_rows(indexes, pair):
    """A stream-layout table is also a gather table: the planes end each
    row, whatever padding lies before them.  Row-gather ranks over the
    stream and pair tables equal the JAX package's sorted rank."""
    from sview_fmindex_tpu_torch.ops.rank import rank_next

    fm, jdev, tdev = indexes
    rng = np.random.default_rng(21 + pair)
    pos = _queries(fm, rng)
    if pair:
        sigma, jtbl, ttbl = 16, jdev.pair_tbl, tdev.pair_tbl
        jmeta = dataclasses.replace(jdev.meta, sigma=16, stream_rows=jdev.meta.pair_rows)
    else:
        sigma, jtbl, ttbl = 4, jdev.stream_tbl, tdev.stream_tbl
        jmeta = jdev.meta
    assert ttbl.shape[1] * 4 == (128 if pair else 64)
    sym = rng.integers(0, sigma, size=pos.shape[0]).astype(np.int64)
    want = np.asarray(jsj.rank_next_sorted(
        jmeta, jtbl, jdev.sentinel, jnp.asarray(pos, jnp.uint32),
        jnp.asarray(sym, jnp.int32), T=T, C=1024))
    meta2 = dataclasses.replace(tdev.meta, sigma=sigma, block_len=tsj.SBL,
                                num_planes=tsj._planes_for(sigma), num_lanes=tsj.LANES)
    got = rank_next(meta2, ttbl, tdev.sentinel, torch.from_numpy(pos), torch.from_numpy(sym))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_join_on_cpu_is_the_plain_version_and_order_free(indexes):
    _, _, tdev = indexes
    rng = np.random.default_rng(11)
    key = torch.from_numpy(rng.integers(0, tdev.stream_tbl.shape[0] * 128 + 3, size=900))
    pay = torch.from_numpy(rng.integers(0, 64, size=900))
    r, s = tsj.join(tdev.stream_tbl, key, pay, 4, False)
    rp, _ = tsj.join_plain(tdev.stream_tbl, key, pay, 4, False)
    assert s is None and torch.equal(r, rp)
    # keys past the table give 0; the answer does not depend on key order
    assert not r[key >= tdev.stream_tbl.shape[0] * 128].any()
    perm = torch.from_numpy(rng.permutation(900))
    r2, _ = tsj.join(tdev.stream_tbl, key[perm], pay[perm], 4, False)
    assert torch.equal(r2, r[perm])
    assert not tsj.LAUNCHES  # no kernel launches on the CPU


@pytest.mark.parametrize("block,n", [
    (fmx.BLOCK3_U64, 3001),    # BL=64
    (fmx.BLOCK2_U32, 777),     # BL=32: 4 fused blocks per stream block
    (fmx.BLOCK3_U128, 4096),   # BL=128: n a multiple of the block
])
def test_derived_wide_stream_table_matches_adapted_reference(block, n):
    fm, _ = _fm(n, block, n, position="u64")
    jdev = JaxDeviceFmIndex.from_host(fm, force_wide=True, dense_lut_entries=0)
    tdev = to_device_torch(fm, "cpu", force_wide=True, dense_lut_entries=0)
    rows, base = tsj.stream_table_wide_from_reference(
        np.asarray(jdev.stream_tbl), np.asarray(jdev.seg_base), 4, jdev.meta.stream_tile, n)
    assert tdev.stream_tbl.shape == (tsj.stream_rows(n), tsj._rw(4))
    assert tdev.seg_base.shape == (1, 4) and tdev.seg_base.dtype == torch.int64
    np.testing.assert_array_equal(tdev.stream_tbl.numpy(), rows)
    np.testing.assert_array_equal(tdev.seg_base.numpy(), base)
    # one segment: its local checkpoints are the narrow table's global ones
    narrow = to_device_torch(fm, "cpu", dense_lut_entries=0, pair=False)
    assert torch.equal(tdev.stream_tbl, narrow.stream_tbl)


@pytest.fixture(scope="module")
def wide_indexes():
    fm, _ = _fm(3001, fmx.BLOCK3_U64, 23, position="u64")
    jdev = JaxDeviceFmIndex.from_host(fm, force_wide=True, dense_lut_entries=0)
    tdev = to_device_torch(fm, "cpu", force_wide=True, dense_lut_entries=0)
    return fm, jdev, tdev


def _lanes(pos):
    return (jnp.asarray((pos >> 32).astype(np.uint32)),
            jnp.asarray((pos & 0xFFFFFFFF).astype(np.uint32)))


@pytest.mark.parametrize("decode", [False, True], ids=["rank_seg", "decode_seg"])
def test_segmented_join_matches_reference(wide_indexes, decode):
    fm, jdev, tdev = wide_indexes
    rng = np.random.default_rng(31 + decode)
    pos = _queries(fm, rng)
    if decode:
        pos = pos[pos < fm.text_len]
        rh, rl, w_sym, w_sent = (np.asarray(a) for a in jwide.pre_rank_and_symidx_sorted_wide(
            jdev.meta, jdev.stream_tbl, jdev.seg_base, jdev.sentinel, *_lanes(pos)))
        g_rank, g_sym, g_sent = (t.numpy() for t in tsj.pre_rank_and_symidx_sorted_wide(
            tdev.stream_tbl, tdev.seg_base, tdev.sentinel, torch.from_numpy(pos), 4))
        np.testing.assert_array_equal(g_sent, w_sent)
        keep = ~w_sent
        np.testing.assert_array_equal(g_sym[keep], w_sym[keep].astype(np.int64))
    else:
        sym = rng.integers(0, 4, size=pos.shape[0]).astype(np.int64)
        rh, rl = (np.asarray(a) for a in jwide.rank_next_sorted_wide(
            jdev.meta, jdev.stream_tbl, jdev.seg_base, jdev.sentinel, *_lanes(pos),
            jnp.asarray(sym, jnp.int32)))
        g_rank = tsj.rank_next_sorted_wide(tdev.stream_tbl, tdev.seg_base, tdev.sentinel,
                                           torch.from_numpy(pos), torch.from_numpy(sym),
                                           4).numpy()
        keep = np.ones(pos.shape[0], bool)
    np.testing.assert_array_equal(g_rank[keep], jwide.combine64(rh, rl)[keep].astype(np.int64))
