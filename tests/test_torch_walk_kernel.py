"""The LF walk's CUDA kernel (sview_fmindex_tpu_torch/csrc/lf_walk.cu) against
its plain version, ``ops/locate.lf_walk`` with the narrow decode.

The indexes are those of ``test_torch_sampled_sa.py``: seeded DNA texts of
20,000, 40,000 and 60,000 symbols at SA sampling r = 2, 32 and 64, uploaded
as the benchmark's ``dna20-1e8-sa32`` deployment is (no full SA).

On a card (``@pytest.mark.cuda``; skipped without one) the kernel's answer
must equal the plain walk's on the same device on every lane, invalid lanes
included: at r = 2, 32 and 64 over batches whose walks meet the sentinel and
which hold overflow rows and invalid lanes; at B = 0, 1, 4096 and 1,048,576;
and on a synthetic fused table of 2^26 + 1 rows whose positions, checkpoint
words and sampled-SA words lie past 2^31.  Under a profiler a locate call
counts the numpy walk's ``walk_row_steps`` and ``walk_steps``,
``walk_lanes`` equal to ``walk_row_steps``, one ``walk_kernel`` and 2
``syncs``; the upload builds the kernel only where no full SA is resident.

On the CPU: ``walk_rows`` never calls the kernel's wrapper or loads its
library and answers as the plain walk with either decode, the wrapper
refuses a CPU tensor and every fault of the rows or the tables before it
loads a library, and ``walk_kernel`` and the walk's counts from the kernel's
buffer are counted at the launch, only while a profiler records.  This file
imports no JAX, so on a machine without it the card tests run with
``python -m pytest tests/test_torch_walk_kernel.py -m cuda --noconftest``.
"""
import contextlib
import ctypes
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import sview_fmindex_tpu_torch as ft  # noqa: E402
from sview_fmindex_tpu_torch import kernels, tracing  # noqa: E402
from sview_fmindex_tpu_torch.ops import locate, stream_join  # noqa: E402
from sview_fmindex_tpu_torch.ops.rank import pre_rank_and_symidx, to_i32  # noqa: E402
from test_torch_sampled_sa import (  # noqa: E402
    UPLOAD, batch, numpy_walk, reference_answer, setup_of)

L = 20


def walk_inputs(dev, pats, lens, spare: int = 0):
    """The expand buffer of a batch: (rows, valid), at the capacity its
    counts need plus ``spare`` slots, which stay invalid."""
    lo, hi = dev.pos_ranges(pats, lens)
    capacity = locate.expand_capacity((hi - lo).cpu().numpy()) + spare
    rows, _, valid, dropped = locate.expand_ranges(lo, hi, capacity)
    assert int(dropped.sum()) == 0
    return rows, valid


def walk_args(dev):
    return dev.meta, dev.fused, dev.count_arr, dev.sa, dev.sentinel


def plain(dev, rows, valid):
    """The plain walk with the narrow decode by fused-row gathers."""
    meta, fused, count_arr, sa, sentinel = walk_args(dev)
    return locate.lf_walk(meta.sampling_ratio, count_arr, sa, rows, valid,
                          lambda pos: pre_rank_and_symidx(meta, fused, sentinel, pos))


def windows(text, B: int, seed: int):
    """B 20-bp windows of the text, a sixteenth of them from its first 64
    positions, whose walks meet the sentinel."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(text) - L + 1, size=B)
    head = rng.random(B) < 1 / 16
    starts[head] = rng.integers(0, 64, size=int(head.sum()))
    return torch.from_numpy(np.ascontiguousarray(text[starts[:, None] + np.arange(L)]))


# ----------------------------------------------------------------------
# on the CPU
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_index():
    text, _, _, fm, dev = setup_of(32)
    return dev, fm, text


def _spy(monkeypatch, module, name):
    """Record each call of ``module.name``."""
    fn = getattr(module, name)
    seen = []

    def wrapper(*args, **kwargs):
        seen.append(args)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapper)
    return seen


def _no_library(monkeypatch):
    """Make loading the kernel's library fail the test."""
    def refuse():
        raise AssertionError("the wrapper loaded the kernel's library")

    monkeypatch.setattr(kernels, "lf_walk_lib", refuse)


@pytest.mark.parametrize("use_stream", [True, False], ids=["join-decode", "gather-decode"])
def test_cpu_walk_never_calls_the_kernel(cpu_index, monkeypatch, use_stream):
    """On the CPU ``walk_rows`` is the plain walk: it never reaches the
    kernel's wrapper or its library, and answers as the plain walk with the
    gather decode on every lane, whichever decode it takes."""
    dev, _, _ = cpu_index
    calls = _spy(monkeypatch, locate, "walk_rows_cuda")
    _no_library(monkeypatch)
    rows, valid = walk_inputs(dev, *batch(32), spare=100)
    assert int((~valid).sum()) >= 100
    got = locate.walk_rows(*walk_args(dev), rows, valid, dev.stream_tbl, use_stream)
    assert calls == []
    assert torch.equal(got, plain(dev, rows, valid))
    pats, lens = batch(32)
    dev.locate_with_counts(pats, lens, use_stream=use_stream)
    assert calls == []


def test_wrapper_refuses_a_cpu_tensor(cpu_index, monkeypatch):
    dev, _, _ = cpu_index
    _no_library(monkeypatch)
    rows, valid = walk_inputs(dev, *batch(32))
    with pytest.raises(ValueError, match="CUDA device"):
        locate.walk_rows_cuda(*walk_args(dev), rows, valid)


def _fake_cuda(monkeypatch):
    """``Tensor.is_cuda`` reads True, so the checks past the device's are
    reached on the CPU (``is_cuda`` is a property of the tensor's class)."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))


FAULTS = {"rows_int32": "rows must", "rows_2d": "rows must", "rows_noncontiguous": "rows must",
          "valid_uint8": "valid must", "valid_short": "valid must",
          "fused_int64": "fused must", "fused_width": "fused must",
          "fused_noncontiguous": "fused must", "count_int32": "count_arr must",
          "sa_int64": "sa must", "sa_2d": "sa must", "wide": "narrow indexes",
          "planes_7": "narrow indexes", "lanes_8": "narrow indexes"}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_wrapper_refuses_before_it_loads_a_library(cpu_index, monkeypatch, fault):
    """A wrong dtype, shape or layout of the rows or of a table, or an
    index the kernel does not serve, is refused with a ValueError, and no
    library is loaded."""
    dev, _, _ = cpu_index
    rows, valid = walk_inputs(dev, *batch(32))
    meta, fused, count_arr, sa, sentinel = walk_args(dev)
    if fault == "rows_int32":
        rows = rows.int()
    elif fault == "rows_2d":
        rows = rows[: rows.shape[0] // 2 * 2].reshape(-1, 2)
    elif fault == "rows_noncontiguous":
        rows = torch.stack([rows, rows], 1)[:, 0]
        assert not rows.is_contiguous()
    elif fault == "valid_uint8":
        valid = valid.to(torch.uint8)
    elif fault == "valid_short":
        valid = valid[:-1]
    elif fault == "fused_int64":
        fused = fused.long()
    elif fault == "fused_width":
        fused = fused[:, :-1].contiguous()
    elif fault == "fused_noncontiguous":
        fused = fused.t().contiguous().t()
    elif fault == "count_int32":
        count_arr = count_arr.int()
    elif fault == "sa_int64":
        sa = sa.long()
    elif fault == "sa_2d":
        sa = sa[None]
    elif fault == "wide":
        meta = dataclasses.replace(meta, wide_pos=True)
    elif fault == "planes_7":
        meta = dataclasses.replace(meta, num_planes=7)
    else:
        meta = dataclasses.replace(meta, num_lanes=8, block_len=256)
    _no_library(monkeypatch)
    _fake_cuda(monkeypatch)
    with pytest.raises(ValueError, match=FAULTS[fault]):
        locate.walk_rows_cuda(meta, fused, count_arr, sa, sentinel, rows, valid)


class _FakeLib:
    """The kernel's library as ctypes shows it, launching nothing: returns
    ``err`` for each call, and where it is given a count buffer writes
    ``counts`` there as the kernel would (decodes of all rows, of the
    longest)."""

    def __init__(self, err: int = 0, counts=(0, 0)):
        self.err, self.counts, self.calls = err, counts, []

    def sview_lf_walk(self, *args):
        self.calls.append(args)
        stats = args[14]
        if stats is not None and not self.err:
            (ctypes.c_int64 * 2).from_address(stats)[:] = list(self.counts)
        return self.err


def _fake_launch(monkeypatch, **kw) -> _FakeLib:
    """The wrapper's launch reached on the CPU: a library that launches
    nothing, and the CUDA device and stream it asks for."""
    lib = _FakeLib(**kw)
    monkeypatch.setattr(kernels, "lf_walk_lib", lambda: lib)
    monkeypatch.setattr(kernels, "cuda_error", lambda e: f"CUDA error {e}")
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    _fake_cuda(monkeypatch)
    return lib


def test_walk_kernel_counted_at_the_launch_only_while_a_profiler_records(cpu_index,
                                                                        monkeypatch):
    """``walk_kernel`` is counted where the kernel launches, beside
    ``LAUNCHES["walk"]``: never for the CPU's plain walk, never outside a
    profiler, once a launch inside one, and not for a launch that failed.
    Outside a profiler the kernel gets no count buffer and nothing is read;
    inside one the buffer is read once (one of the ``syncs``) into
    ``walk_row_steps``, ``walk_lanes`` (the same number) and
    ``walk_steps``."""
    from torch.profiler import ProfilerActivity, profile

    dev, _, _ = cpu_index
    monkeypatch.setattr(tracing, "COUNTS", tracing.COUNTS.__class__())
    monkeypatch.setattr(locate, "LAUNCHES", locate.LAUNCHES.__class__())
    pats, lens = batch(32)
    with profile(activities=[ProfilerActivity.CPU]):
        dev.locate_with_counts(pats, lens)
    assert tracing.COUNTS["walk_steps"] > 0 and "walk_kernel" not in tracing.COUNTS
    assert not locate.LAUNCHES
    rows, valid = walk_inputs(dev, pats, lens)
    tracing.COUNTS.clear()
    lib = _fake_launch(monkeypatch, counts=(31_000, 400))
    locate.walk_rows(*walk_args(dev), rows, valid)
    assert len(lib.calls) == 1 and lib.calls[0][14] is None and locate.LAUNCHES["walk"] == 1
    assert not tracing.COUNTS
    with profile(activities=[ProfilerActivity.CPU]):
        locate.walk_rows(*walk_args(dev), rows, valid)
    assert len(lib.calls) == 2 and lib.calls[1][14] is not None
    assert locate.LAUNCHES["walk"] == 2
    assert dict(tracing.COUNTS) == {"walk_kernel": 1, "syncs": 1, "walk_steps": 400,
                                    "walk_row_steps": 31_000, "walk_lanes": 31_000}
    lib.err = 700
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            locate.walk_rows(*walk_args(dev), rows, valid)
    assert locate.LAUNCHES["walk"] == 2 and tracing.COUNTS["walk_kernel"] == 1


def test_wrapper_hands_the_kernel_its_arguments(cpu_index, monkeypatch):
    """The launch's arguments: the index's layout, sigma, tables, sentinel
    and sampling ratio, the rows and their count, an output of their shape,
    and no count buffer outside a profiler."""
    dev, _, _ = cpu_index
    rows, valid = walk_inputs(dev, *batch(32))
    lib = _fake_launch(monkeypatch)
    out = locate.walk_rows_cuda(*walk_args(dev), rows, valid)
    (args,) = lib.calls
    meta = dev.meta
    assert args[:3] == (meta.num_planes, meta.num_lanes, meta.sigma)
    assert args[3:5] == (dev.fused.data_ptr(), dev.fused.shape[1])
    assert args[5:10] == (dev.count_arr.data_ptr(), dev.count_arr.shape[0], dev.sa.data_ptr(),
                          dev.sentinel, 32)
    assert args[10:14] == (rows.data_ptr(), valid.data_ptr(), rows.shape[0], out.data_ptr())
    assert out.shape == rows.shape and out.dtype == torch.int64 and args[14] is None


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


_CARD = {}


def card_index(r: int):
    """The ratio's index uploaded to the card (cached for the module)."""
    if r not in _CARD:
        text, sa, isa, fm, _ = setup_of(r)
        dev = ft.to_device_torch(fm, "cuda", **UPLOAD)
        assert not dev.meta.has_sa_full and dev.meta.sampling_ratio == r
        _CARD[r] = dev, text, sa, isa
    return _CARD[r]


def assert_kernel_is_plain(dev, rows, valid):
    """Kernel and plain walk on the same device, equal on every lane;
    returns the kernel's answer."""
    before = locate.LAUNCHES["walk"]
    got = locate.walk_rows(*walk_args(dev), rows, valid)
    assert locate.LAUNCHES["walk"] == before + 1
    want = plain(dev, rows, valid)
    torch.cuda.synchronize()
    assert got.dtype == torch.int64 and got.shape == rows.shape
    assert torch.equal(got, want)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("r", [2, 32, 64])
def test_kernel_equals_the_plain_walk(cuda, r):
    """The sampled-SA test's batch (20-bp windows, short patterns of tens
    to hundreds of occurrences, the windows at the text's start) and 300
    invalid slots: equal on every lane, and each valid row's answer is the
    full SA's value at that row."""
    dev, _, sa, _ = card_index(r)
    pats, lens = batch(r)
    rows, valid = walk_inputs(dev, pats.to(cuda), lens, spare=300)
    assert int((~valid).sum()) >= 300 and rows.shape[0] > pats.shape[0] + 1000
    got = assert_kernel_is_plain(dev, rows, valid)
    v = valid.cpu()
    assert np.array_equal(got.cpu()[v].numpy(), sa[rows.cpu()[v].numpy()])


@pytest.mark.cuda
@pytest.mark.parametrize("B", [0, 1, 4096, 1 << 20])
def test_kernel_batch_sizes(cuda, B):
    """B windows at r = 32 through ``locate_with_counts`` as a caller sends
    them, and their expand buffer through both walks: equal on every lane
    (B = 0 is a buffer of invalid lanes alone)."""
    dev, text, _, _ = card_index(32)
    pats = windows(text, B, seed=B)
    rows, valid = walk_inputs(dev, pats.to(cuda), None)
    assert rows.shape[0] >= B + 64 and int(valid.sum()) >= B
    assert_kernel_is_plain(dev, rows, valid)
    before = locate.LAUNCHES["walk"]
    locs, _, v, _, dropped = dev.locate_with_counts(pats.to(cuda))
    assert locate.LAUNCHES["walk"] == before + 1 and int(dropped.sum()) == 0
    if B:
        assert int(v.sum()) >= B
    torch.cuda.synchronize()


def test_windows_include_the_text_start():
    text = setup_of(32)[0]
    pats = windows(text, 4096, seed=3).numpy()
    starts = {bytes(text[s:s + L]) for s in range(64)}
    assert sum(bytes(p) in starts for p in pats) > 100


HIGH_ROWS = (1 << 26) + 1  # blocks of 64 positions: every u32 position has a row
HIGH_R = 32


@pytest.mark.cuda
def test_kernel_past_2_31(cuda):
    """A synthetic fused table of 2^26 + 1 rows at dna20's layout (2 GB):
    random plane words, checkpoint words random in [2^31, 2^32 - 2^16)
    (negative as int32), the sentinel past 2^31 and sampled-SA words in
    [2^31, 2^32 - 2^16): every position a walk visits past its first lies
    past 2^31.  A walk over such a table is a random map, so the test first
    walks every row in plain torch with a cap of 4000 steps and requires all
    to end; then kernel and plain walk are equal on every lane, and answers
    past 2^31 are seen."""
    dev, _, _, _ = card_index(HIGH_R)
    g = torch.Generator(device=cuda).manual_seed(31)
    meta = dev.meta
    width = meta.sigma + meta.num_planes * meta.num_lanes
    fused = torch.randint(-2**31, 2**31, (HIGH_ROWS, width), generator=g,
                          device=cuda).to(torch.int32)
    fused[:, :meta.sigma] = to_i32(torch.randint(2**31, 2**32 - 2**16, (HIGH_ROWS, meta.sigma),
                                                 generator=g, device=cuda))
    sa = to_i32(torch.randint(2**31, 2**32 - 2**16, (2**32 // HIGH_R,), generator=g, device=cuda))
    high = dataclasses.replace(dev, fused=fused, sa=sa, sentinel=2**31 + 12345,
                               count_arr=torch.arange(meta.sigma + 1, device=cuda) * 1000)
    B = 1 << 16
    rows = torch.randint(0, 2**32 - 2**16, (B,), generator=g, device=cuda)
    rows[:4] = torch.tensor([0, high.sentinel - 1, high.sentinel, 2**31], device=cuda)
    valid = torch.rand(B, generator=g, device=cuda) < 0.95
    pos, live = rows.clone(), valid & (rows % HIGH_R != 0)
    for _ in range(4000):
        if not bool(live.any()):
            break
        rank, sym, sent = pre_rank_and_symidx(high.meta, fused, high.sentinel, pos)
        pos = torch.where(live & ~sent, high.count_arr[sym] + rank, pos)
        live = live & ~sent & (pos % HIGH_R != 0)
    assert not bool(live.any()), "a walk of the synthetic table did not end in 4000 steps"
    assert int(pos.min()) >= 0 and int(pos.max()) < 2**32
    got = assert_kernel_is_plain(high, rows, valid)
    assert int((got[valid] >= 2**31).sum()) > B // 2
    del high, fused, sa
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("r", [2, 32, 64])
def test_kernel_counts_under_a_profiler(cuda, r):
    """A locate call on the card under a profiler: ``walk_row_steps`` and
    ``walk_steps`` are the numpy walk's over the located rows,
    ``walk_lanes`` equals ``walk_row_steps``, one ``walk_kernel``, and 2
    ``syncs`` (the capacity read and the kernel's counts)."""
    dev, _, sa, isa = card_index(r)
    pats, lens = batch(r)
    _, _, ref_pos = reference_answer(r)
    steps, _ = numpy_walk(sa, isa, r, isa[ref_pos.numpy()])
    tracing.COUNTS.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        dev.locate_with_counts(pats.to(cuda), lens)
    got = dict(tracing.COUNTS)
    assert got["walk_row_steps"] == int(steps.sum())
    assert got["walk_steps"] == int(steps.max())
    assert got["walk_lanes"] == got["walk_row_steps"]
    assert got["walk_kernel"] == 1 and got["syncs"] == 2
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_upload_builds_the_kernel_only_without_a_full_sa(cuda, monkeypatch):
    """A narrow upload to the card builds the walk's kernel where it will
    walk, and not where the full SA is filled on the card; a walk on the
    full-SA index launches no walk kernel and no decode of the join."""
    _, _, _, fm, _ = setup_of(32)
    built = _spy(monkeypatch, kernels, "lf_walk_lib")
    full = ft.to_device_torch(fm, "cuda", sa_full="device", **UPLOAD)
    assert built == [] and full.meta.has_sa_full
    ft.to_device_torch(fm, "cuda", **UPLOAD)
    assert len(built) == 1
    pats, lens = batch(32)
    before = locate.LAUNCHES["walk"], stream_join.LAUNCHES["decode"]
    full.locate_with_counts(pats.to(cuda), lens)
    assert (locate.LAUNCHES["walk"], stream_join.LAUNCHES["decode"]) == before
    torch.cuda.synchronize()
