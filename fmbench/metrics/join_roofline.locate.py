"""The join kernel's share of its roofline, in %, on the cell's own table in
its main rank mode: the least time its work's bytes need at the card's
memory rate (``peaks.json``) over the kernel's time by CUDA events
(``probe_join.py``).  Nothing where the card is not in ``peaks.json``, the
table is not the layout the probe's plain copy reads, or the kernel
differs from that copy."""
from fmbench import probe_join


def probe(run):
    import torch

    peak = probe_join.peak_bytes_per_s(run)
    if peak is None:
        return
    gen = torch.Generator(device=run.device)
    gen.manual_seed(int(run.generator(3).integers(0, 2**62)))
    run.probes["join_roofline"] = probe_join.measure(run.dev, int(run.text.shape[0]), gen, peak)


def read(run):
    got = run.probes.get("join_roofline")
    return got["share_pct"] if got else None
