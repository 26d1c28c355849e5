"""Patterns answered by ``locate_with_counts`` per second: every pattern of
the window over the whole window, on the host clock (each call ends with its
answers ready)."""


def read(run):
    if run.op != "locate" or run.window_s <= 0:
        return None
    return run.patterns_done / run.window_s
