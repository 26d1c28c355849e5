"""A run with its timed path broken underneath comes out not correct: half
of each batch left out, or one answer altered where it is produced.  The
rest of the run is the harness's own, in this process, on the CPU."""
import pytest
import torch

import fmbench.run as R
from conftest import small_args


def run_cell(cell):
    code, result = R.run_cell(R.parse(small_args(cell, seconds="0.2")))
    assert code == 0
    return result


@pytest.mark.parametrize("cell", ["dna20-1e8.locate-1m", "dna20-1e8.count-1m"])
def test_half_the_batch_left_out(cell, monkeypatch):
    from sview_fmindex_tpu_torch.models.device_index import DeviceFmIndex

    count, locate = DeviceFmIndex.count, DeviceFmIndex.locate_with_counts

    def half_count(self, patterns, lens=None, **kw):
        B = patterns.shape[0]
        out = count(self, patterns[:B // 2], None if lens is None else lens[:B // 2], **kw)
        return torch.cat([out, torch.zeros(B - B // 2, dtype=out.dtype)])

    def half_locate(self, patterns, lens=None, **kw):
        B = patterns.shape[0]
        locs, pids, valid, counts, dropped = locate(
            self, patterns[:B // 2], None if lens is None else lens[:B // 2], **kw)
        counts = torch.cat([counts, torch.zeros(B - B // 2, dtype=counts.dtype)])
        return locs, pids, valid, counts, dropped

    monkeypatch.setattr(DeviceFmIndex, "count", half_count)
    monkeypatch.setattr(DeviceFmIndex, "locate_with_counts", half_locate)
    res = run_cell(cell)
    assert res["correct"] is False
    assert res["checks"]["count_mismatch"]["value"] > 0


def test_a_located_position_altered(monkeypatch):
    from sview_fmindex_tpu_torch.ops import locate as locate_ops

    rows = locate_ops.locate_rows

    def altered(*args, **kw):
        locs, pids, valid, dropped = rows(*args, **kw)
        locs = locs.clone()
        locs[0] += 1
        return locs, pids, valid, dropped

    monkeypatch.setattr(locate_ops, "locate_rows", altered)
    res = run_cell("dna20-1e8.locate-1m")
    assert res["correct"] is False
    assert res["checks"]["locate_mismatch"]["value"] > 0
    assert res["checks"]["count_mismatch"]["value"] == 0


def test_a_count_altered(monkeypatch):
    from sview_fmindex_tpu_torch.ops import search as search_ops

    ranges = search_ops.pos_ranges

    def altered(*args, **kw):
        lo, hi = ranges(*args, **kw)
        hi = hi.clone()
        hi[0] += 1
        return lo, hi

    monkeypatch.setattr(search_ops, "pos_ranges", altered)
    res = run_cell("dna20-1e8.count-1m")
    assert res["correct"] is False
    assert res["checks"]["count_mismatch"]["value"] > 0
