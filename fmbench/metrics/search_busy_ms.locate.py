"""Device milliseconds per call of the kernels, copies and memsets launched
inside the program's ``fmindex.search`` span (encode, seed and every pass of
the search), over the traced window (``spans.py``)."""
from fmbench import spans


def read(run):
    return spans.busy_ms(run, "fmindex.search")
