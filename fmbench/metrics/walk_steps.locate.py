"""Steps per call of the LF walk that decode, one decode launch each: the
longest walk of any located row (the program's ``COUNTS["walk_steps"]``
over ``COUNTS["calls"]``, both counted only in the traced window).  None
for a program that does not count them, or a call that does not walk."""
from fmbench import spans


def read(run):
    got = spans.counts()
    if got is None or "walk_steps" not in got:
        return None
    return spans.per_call(run, "walk_steps")
