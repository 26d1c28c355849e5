"""Device milliseconds per call of the kernels, copies and memsets launched
inside the program's ``fmindex.resolve`` span (expand the ranges, then the SA
gather or the LF walk), over the traced window (``spans.py``)."""
from fmbench import spans


def read(run):
    return spans.busy_ms(run, "fmindex.resolve")
