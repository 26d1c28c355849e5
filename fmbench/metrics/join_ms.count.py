"""Device milliseconds per call of the join kernel (kernels named
``join_kernel``, ``csrc/join.cu``) over the traced window."""
from fmbench import tracing


def read(run):
    return run.trace.ms_per_call(tracing.JOIN_KERNELS) if run.trace else None
