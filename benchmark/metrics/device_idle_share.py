"""1 - busy / wall of the profiled epoch, busy being the union of the
device operations' intervals."""


def read(run):
    if run.profile is None:
        return None
    return run.profile.summary["device_idle_share"]
