"""Seconds to import torch and ``sview_fmindex_tpu_torch``, on the
harness's clock around the imports."""


def read(run):
    return run.clocks.get("import_s")
