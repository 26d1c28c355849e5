"""% of the traced window in which no kernel, copy or memset ran on the
device (``tracing.TraceSummary.idle_share``)."""


def read(run):
    return run.trace.idle_share() if run.trace else None
