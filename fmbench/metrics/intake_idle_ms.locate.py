"""Milliseconds per call in which the device sat idle while the caller was
inside the program's ``fmindex.intake`` span (the batch put on the index's
device and its host facts), over the traced window (``spans.py``)."""
from fmbench import spans


def read(run):
    return spans.idle_ms(run, "fmindex.intake")
