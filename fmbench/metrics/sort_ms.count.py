"""Device milliseconds per call of the sort kernels (``tracing.SORT_KERNELS``:
``torch.sort``'s radix and small-segment sorts, the search's per-pass sort)
over the traced window."""
from fmbench import tracing


def read(run):
    return run.trace.ms_per_call(tracing.SORT_KERNELS) if run.trace else None
