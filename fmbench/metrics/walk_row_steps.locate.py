"""LF steps per call that the located rows take: the live rows of the walk
summed over its steps, set by the index's sampling and the rows, not by how
the walk runs (the program's ``COUNTS["walk_row_steps"]`` over
``COUNTS["calls"]``, both counted only in the traced window).  None for a
program that does not count them, or a call that does not walk."""
from fmbench import spans


def read(run):
    got = spans.counts()
    if got is None or "walk_row_steps" not in got:
        return None
    return spans.per_call(run, "walk_row_steps")
