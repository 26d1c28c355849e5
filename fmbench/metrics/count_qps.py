"""Patterns answered by ``count`` per second: every pattern of the window
over the whole window, on the host clock (each call ends with its counts
ready)."""


def read(run):
    if run.op != "count" or run.window_s <= 0:
        return None
    return run.patterns_done / run.window_s
