"""Seconds of the upload, the sum of the program's own
``DeviceFmIndex.upload_phases`` (each phase ends with a device
synchronisation)."""


def read(run):
    phases = run.details.get("upload_phases")
    return float(sum(phases.values())) if phases else None
