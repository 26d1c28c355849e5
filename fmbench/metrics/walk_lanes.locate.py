"""Lanes per call that the LF walk sent to decode, summed over its steps;
against ``walk_row_steps.locate`` it reads the decodes spent on rows already
resolved (the program's ``COUNTS["walk_lanes"]`` over ``COUNTS["calls"]``,
both counted only in the traced window).  None for a program that does not
count them, or a call that does not walk."""
from fmbench import spans


def read(run):
    got = spans.counts()
    if got is None or "walk_lanes" not in got:
        return None
    return spans.per_call(run, "walk_lanes")
