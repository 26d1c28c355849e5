"""Rows located per call: the sum of every pattern's count, which the
program reads on the host to size the expand buffer (its ``COUNTS["rows"]``
over ``COUNTS["calls"]``, both counted only in the traced window).  None
for a program that does not count them."""
from fmbench import spans


def read(run):
    got = spans.counts()
    if got is None or "rows" not in got:
        return None
    return spans.per_call(run, "rows")
