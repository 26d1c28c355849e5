"""Milliseconds per call in which the device sat idle while the caller was
inside the program's ``fmindex.capacity`` span (the counts read on the host to
size the locate buffer), over the traced window (``spans.py``)."""
from fmbench import spans


def read(run):
    return spans.idle_ms(run, "fmindex.capacity")
