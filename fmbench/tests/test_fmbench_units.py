"""The yardstick's arithmetic on hand-worked cases: the join's bytes, the
frozen plain rank against the port's table, the trace reduction."""
import numpy as np
import torch

from fmbench import probe_join, tracing


def test_work_bytes_by_hand():
    # 5 keys: 5 x (8 key + 8 symbol + 8 rank) = 120 B; blocks 0, 1 and 2,
    # each 128 symbols of 2 bits = 32 B: 96 B; (block, symbol) asked:
    # (0,1) (1,2) (1,1) (2,3) = 4 counts of 4 B: 16 B
    keys = torch.tensor([0, 5, 130, 131, 300])
    syms = torch.tensor([1, 1, 2, 1, 3])
    assert probe_join.work_bytes(keys, syms, 4) == 120 + 96 + 16
    # sigma 20: 5 bits a symbol, 80 B a block; sigma 16: 4 bits, 64 B
    assert probe_join.work_bytes(keys, syms, 20) == 120 + 3 * 80 + 16
    assert probe_join.work_bytes(keys, syms, 16) == 120 + 3 * 64 + 16


def test_plain_rank_against_the_text():
    """The frozen plain rank over the port's uploaded tables (pair table at
    sigma 16, stream table at sigma 20) equals counts taken from the BWT."""
    import sview_fmindex_tpu_torch as ft
    from sview_fmindex_tpu_torch.ops import stream_join

    rng = np.random.default_rng(8)
    for symbols, block in ((b"ACGT", ft.BLOCK3_U64), (b"ARNDCQEGHILKMFPSTWYV", ft.BLOCK5_U64)):
        n = 20000
        text = np.frombuffer(symbols, np.uint8)[rng.integers(0, len(symbols), size=n)]
        enc = ft.EncodingTable.from_symbols([bytes([c]) for c in symbols])
        b = ft.FmIndexBuilder(n, enc.symbol_count(), enc, position="u32", block=block,
                              suffix_array_config=ft.SuffixArrayConfig.compressed(2),
                              lookup_table_config=ft.LookupTableConfig.kmer_size(2))
        fm = ft.FmIndex.load(np.frombuffer(b.build(text), np.uint8).copy(), position="u32",
                             block=block)
        dev = ft.to_device_torch(fm, "cpu", sa_full="device", dense_lut_entries=4096)
        table, sigma = probe_join.main_table(dev)
        assert table.shape[1] == probe_join.row_words(sigma)
        keys = torch.sort(torch.from_numpy(rng.integers(0, n + 1, size=5000)))[0]
        syms = torch.from_numpy(rng.integers(0, sigma, size=5000))
        want, _ = stream_join.join_plain(table, keys, syms, sigma, False)
        assert torch.equal(probe_join.plain_rank(table, keys, syms, sigma), want)


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_reduction_by_hand():
    events = [
        _x(tracing.WINDOW, "user_annotation", 100, 100),        # window [100, 200]
        _x("fmbench.call", "user_annotation", 100, 100),
        _x("aten::sort", "cpu_op", 105, 20),                     # covers the gap [110, 120]
        _x("cudaStreamSynchronize", "cuda_runtime", 150, 48),    # covers [160, 190]
        _x("void join_kernel<4, false, false>(JoinArgs)", "kernel", 90, 20),   # [100, 110]
        _x("void cub::DeviceRadixSortOnesweepKernel<int>(int*)", "kernel", 120, 30),
        _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 140, 20),  # overlaps: [120, 160]
        _x("void cub::DeviceRadixSortOnesweepKernel<int>(int*)", "kernel", 190, 30),  # [190, 200]
    ]
    s = tracing.TraceSummary(events, calls=2)
    assert s.window_s == 100e-6
    assert abs(s.busy_s - 60e-6) < 1e-12
    assert abs(s.idle_share() - 40.0) < 1e-9
    assert abs(s.ms_per_call(tracing.SORT_KERNELS) - 40e-3 / 2) < 1e-12
    assert abs(s.ms_per_call(tracing.JOIN_KERNELS) - 10e-3 / 2) < 1e-12
    gaps = dict(s.idle_gaps)
    assert abs(gaps["aten::sort"] - 10e-6) < 1e-12
    assert abs(gaps["cudaStreamSynchronize"] - 30e-6) < 1e-12
    assert dict(s.device_ops)["join_kernel<4, false, false>"] == 10e-6
