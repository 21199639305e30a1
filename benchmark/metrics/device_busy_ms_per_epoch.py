"""Milliseconds of the profiled epoch in which an operation ran on the
device (the union of their intervals)."""


def read(run):
    if run.profile is None:
        return None
    return run.profile.summary["device_busy_ms"]
