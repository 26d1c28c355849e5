"""The expand buffer sized on the device (``ops.locate.device_capacity``).

Two sums of the counts reduced where the counts lie and read in one copy
give the same ``(capacity, rows)`` as ``expand_capacity`` and a sum over
the counts on the host, for any counts: none, all zero, all one, seeded
mixes below and above 64 lanes, and one count of 2^33 (past int32 and past
the expand's saturating prefix sum).  A ``locate_with_counts`` that sizes its
own buffer answers exactly as one handed the host-sized capacity, on the
three indexes of ``test_torch_tracing.py``: DNA and protein with the full SA
on the device, and DNA through the LF walk.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from sview_fmindex_tpu_torch.ops.locate import device_capacity, expand_capacity  # noqa: E402
from test_torch_tracing import batch, index  # noqa: E402


def mixed(B, seed):
    """Seeded counts, a third of them zero, the rest up to 40."""
    rng = np.random.default_rng(seed)
    return np.where(rng.random(B) < 1 / 3, 0, rng.integers(1, 41, size=B))


COUNTS = {
    "empty": np.zeros(0, np.int64),
    "zeros": np.zeros(100, np.int64),
    "ones": np.ones(100, np.int64),
    "mixed-50": mixed(50, 1),
    "mixed-63": mixed(63, 2),
    "mixed-64": mixed(64, 3),
    "mixed-65": mixed(65, 4),
    "mixed-1000": mixed(1000, 5),
    "overflow-one-past-64": np.array([1] * 10 + [66] + [0] * 5),
    "one-of-2^33": np.array([3, 0, 2 ** 33, 1, 0, 7]),
}


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_device_capacity_equals_the_host_sizing(name):
    counts = COUNTS[name].astype(np.int64)
    got = device_capacity(torch.from_numpy(counts))
    assert got == (expand_capacity(counts), int(counts.sum()))
    assert all(type(v) is int for v in got)


@pytest.mark.parametrize("name,lens_kind", [("dna", None), ("dna", "host"), ("prot", "host"),
                                            ("prot", "device"), ("dna-walk", None),
                                            ("dna-walk", "host")])
def test_locate_equals_a_call_given_the_host_capacity(name, lens_kind):
    dev = index(name)[2]
    pats, lens, _ = batch(name, lens_kind)
    lo, hi = dev.pos_ranges(pats, lens)
    capacity = expand_capacity((hi - lo).cpu().numpy())
    own = dev.locate_with_counts(pats, lens)
    given = dev.locate_with_counts(pats, lens, capacity=capacity)
    assert own[0].shape[0] == capacity
    for a, b in zip(own, given):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)
    assert int(own[4].sum()) == 0
