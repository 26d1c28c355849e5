"""The port against the Rust-interop corpus (``interop/corpus/``).

Every committed case (DNA at sigma 4, wildcard DNA at sigma 5, protein at
sigma 20 and 24, pass-through alphabets of 9 and 40 symbols, u32 and u64
blobs) is loaded with the port's re-exported host API, uploaded to the CPU
with ``to_device_torch`` (narrow, and wide with ``force_wide``), and its
recorded queries go through the stream and gather engines: the counts and
sorted locations must equal the manifest's, the answers the reference Rust
crate's format defines.  The ``cuda`` cases (``@pytest.mark.cuda``; skipped
without a card) upload the same blobs to the card with no device named; this
file imports no JAX, so on a machine without it they run with
``python -m pytest tests/test_torch_corpus.py -m cuda --noconftest``.
"""
import base64
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import sview_fmindex_tpu_torch as ft  # noqa: E402

CORPUS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "interop", "corpus")


def _cases():
    with open(os.path.join(CORPUS, "corpus.json")) as f:
        return [pytest.param(c, id=c["name"]) for c in json.load(f)["cases"]]


# (wide, on the card): the CPU cases keep their ids, the card's are marked
SHAPES = [pytest.param(False, False, id="narrow"), pytest.param(True, False, id="wide"),
          pytest.param(False, True, id="narrow-cuda", marks=pytest.mark.cuda),
          pytest.param(True, True, id="wide-cuda", marks=pytest.mark.cuda)]


@pytest.mark.parametrize("wide,on_card", SHAPES)
@pytest.mark.parametrize("case", _cases())
def test_port_answers_the_manifest(case, wide, on_card):
    if on_card and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    blob = np.fromfile(os.path.join(CORPUS, case["blob"]), dtype=np.uint8)
    fm = ft.FmIndex.load(blob, position=case["position"], block=getattr(ft, case["block"]),
                         encoder_kind=case["encoder"])
    dev = ft.to_device_torch(fm, None if on_card else "cpu", force_wide=wide)
    assert dev.device.type == ("cuda" if on_card else "cpu")
    assert dev.meta.wide_pos == wide
    assert dev.meta.stream_rows > 0  # every corpus alphabet is within sigma <= 63
    assert (dev.meta.pair_rows > 0) == (not wide and fm.symbol_count ** 2 <= 63)
    pats = [base64.b64decode(q["pattern"]) for q in case["queries"]]
    batch, lens = ft.pack_patterns(pats)
    for use_stream in (True, False):
        counts = dev.count(batch, lens, use_stream=use_stream)
        assert counts.tolist() == [q["count"] for q in case["queries"]]
        locs, pids, valid, _, dropped = dev.locate_with_counts(batch, lens,
                                                               use_stream=use_stream)
        assert int(dropped[0]) == 0
        for i, q in enumerate(case["queries"]):
            got = sorted(locs[valid & (pids == i)].tolist())
            assert got == q["locations"], (case["name"], use_stream, pats[i])
