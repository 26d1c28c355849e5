"""Device milliseconds per call of the kernels, copies and memsets launched
inside the program's ``fmindex.intake`` span (the batch put on the index's
device and its host facts), over the traced window (``spans.py``)."""
from fmbench import spans


def read(run):
    return spans.busy_ms(run, "fmindex.intake")
