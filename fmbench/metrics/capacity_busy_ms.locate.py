"""Device milliseconds per call of the kernels, copies and memsets launched
inside the program's ``fmindex.capacity`` span (the counts read on the host to
size the locate buffer), over the traced window (``spans.py``)."""
from fmbench import spans


def read(run):
    return spans.busy_ms(run, "fmindex.capacity")
