"""Passes over per-lane lengths per call that batch intake made to derive
its host facts (the LF trip count, all-dense, one shared length): 1 for a
batch handed in with lengths, 0 for one whose facts come from its shape
(the program's ``COUNTS["intake_scans"]`` over ``COUNTS["calls"]``, both
counted only in the traced window).  None for a program that does not count
them."""
from fmbench import spans


def read(run):
    got = spans.counts()
    if got is None or "intake_scans" not in got:
        return None
    return spans.per_call(run, "intake_scans")
