"""MB (1e6 bytes) per call of the batch put on the index's device: its
patterns, and its lengths where the caller gave them (the program's
``COUNTS["intake_bytes"]`` over ``COUNTS["calls"]``, both counted only in the
traced window)."""
from fmbench import spans


def read(run):
    return spans.per_call(run, "intake_bytes", 1e-6)
