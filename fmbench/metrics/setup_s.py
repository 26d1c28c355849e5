"""Seconds from the start of the run's script to the start of the window:
imports, the text, the host build, the upload, the pool and the warm
calls."""


def read(run):
    return run.clocks.get("setup_s")
