"""Milliseconds per call in which the device sat idle while the caller was
inside the program's ``fmindex.resolve`` span (expand the ranges, then the SA
gather or the LF walk), over the traced window (``spans.py``)."""
from fmbench import spans


def read(run):
    return spans.idle_ms(run, "fmindex.resolve")
