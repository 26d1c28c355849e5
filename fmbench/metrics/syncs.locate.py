"""Points per call at which the host waited for a value on the device: the
capacity read, each step test of the LF walk, lengths handed in on the
device (the program's ``COUNTS["syncs"]`` over ``COUNTS["calls"]``, both
counted only in the traced window)."""
from fmbench import spans


def read(run):
    return spans.per_call(run, "syncs")
