"""The 95th percentile of every batch's latency in the window, in ms: from
the call to its results ready (on the host, where the mix copies them
there), on the host clock."""
import numpy as np


def read(run):
    if len(run.latencies) < 20:
        return None
    return float(np.percentile(np.asarray(run.latencies), 95)) * 1e3
