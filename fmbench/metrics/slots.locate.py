"""Slots of the expand buffer per call: the capacity ``expand_ranges``
fills, ``B`` base slots and the overflow rounded up to a power of two (the
program's ``COUNTS["slots"]`` over ``COUNTS["calls"]``, both counted only in
the traced window).  None for a program that does not count them."""
from fmbench import spans


def read(run):
    got = spans.counts()
    if got is None or "slots" not in got:
        return None
    return spans.per_call(run, "slots")
