"""The comparison that decides ``correct``: the program's answers to the
window's own batches against the plain reference (``reference.py``).

Every number compared has its limit here.  The guarantee every
configuration states is an exact match, so each limit is 0: one pattern
with a count or a set of positions that differs from the reference's makes
the run not correct.
"""
from __future__ import annotations

import torch

LIMITS = {
    # patterns whose count differs from the reference's
    "count_mismatch": 0,
    # patterns whose set of located positions differs from the reference's
    # (a position missing, extra, repeated, or a hit dropped by the program)
    "locate_mismatch": 0,
    # batches of the compared sample that the window never answered
    "unanswered": 0,
}


def _pair_keys(pid: torch.Tensor, pos: torch.Tensor, n: int) -> torch.Tensor:
    return pid.long() * (n + 1) + pos.long()


def mismatched_patterns(prog_keys: torch.Tensor, ref_keys: torch.Tensor, n: int) -> int:
    """Patterns whose multiset of (pattern, position) pairs differs between
    the two sides."""
    if prog_keys.shape == ref_keys.shape and torch.equal(
            torch.sort(prog_keys)[0], ref_keys):
        return 0
    both = torch.cat([prog_keys, ref_keys])
    side = torch.cat([torch.ones_like(prog_keys), -torch.ones_like(ref_keys)])
    uniq, inv = torch.unique(both, return_inverse=True)
    balance = torch.zeros_like(uniq).scatter_add_(0, inv, side)
    return int(torch.unique(uniq[balance != 0] // (n + 1)).numel())


class Verdict:
    """Running totals over the compared batches."""

    def __init__(self, op: str):
        self.op = op
        self.values = {"count_mismatch": 0, "unanswered": 0}
        if op == "locate":
            self.values["locate_mismatch"] = 0
        self.compared = 0

    def add(self, ref, out, n: int, device) -> None:
        """``ref``: (counts, pid, pos) of the reference.  ``out``: what the
        program returned for the batch (``count``: counts; ``locate``: locs,
        pids, valid, counts, dropped), None if never answered."""
        counts_ref, pid_ref, pos_ref = ref
        B = counts_ref.shape[0]
        self.compared += B
        if out is None:
            self.values["unanswered"] += 1
            return
        if self.op == "count":
            counts = out.to(device)
            self.values["count_mismatch"] += int((counts != counts_ref).sum())
            return
        locs, pids, valid, counts, _ = (t.to(device) for t in out)
        self.values["count_mismatch"] += int((counts != counts_ref).sum())
        prog = _pair_keys(pids[valid], locs[valid], n)
        self.values["locate_mismatch"] += mismatched_patterns(
            prog, _pair_keys(pid_ref, pos_ref, n), n)

    def checks(self) -> dict:
        return {k: {"value": v, "limit": LIMITS[k]} for k, v in self.values.items()}

    def correct(self) -> bool:
        return self.compared > 0 and all(v <= LIMITS[k] for k, v in self.values.items())
