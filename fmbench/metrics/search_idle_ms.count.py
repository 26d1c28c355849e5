"""Milliseconds per call in which the device sat idle while the caller was
inside the program's ``fmindex.search`` span (encode, seed and every pass of
the search), over the traced window (``spans.py``)."""
from fmbench import spans


def read(run):
    return spans.idle_ms(run, "fmindex.search")
