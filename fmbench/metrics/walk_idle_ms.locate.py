"""Milliseconds per call in which the device sat idle while the caller was
inside the program's ``fmindex.walk`` span (the LF walk: each step's test
read on the host and its launches), over the traced window (``spans.py``).
None for a program without the span, or a call that does not walk."""
from fmbench import spans


def read(run):
    return spans.idle_ms(run, "fmindex.walk")
