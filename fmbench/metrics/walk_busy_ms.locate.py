"""Device milliseconds per call of the kernels, copies and memsets launched
inside the program's ``fmindex.walk`` span (the LF walk's steps and its read
of the sampled SA, nested in ``fmindex.resolve``), over the traced window
(``spans.py``).  None for a program without the span, or a call that does
not walk."""
from fmbench import spans


def read(run):
    return spans.busy_ms(run, "fmindex.walk")
