"""Bytes per call that the capacity sync copied to the host to size the
expand buffer: two int64 sums reduced on the device, 16 (the program's
``COUNTS["capacity_bytes"]`` over ``COUNTS["calls"]``, both counted only in
the traced window).  None for a program that does not count them."""
from fmbench import spans


def read(run):
    got = spans.counts()
    if got is None or "capacity_bytes" not in got:
        return None
    return spans.per_call(run, "capacity_bytes")
