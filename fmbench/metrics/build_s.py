"""Seconds of the port's host build of the blob (``FmIndexBuilder.build``,
SA-IS included), on the harness's clock around the call."""


def read(run):
    return run.clocks.get("build_s")
