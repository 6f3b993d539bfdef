"""The share of the traced part of the window in which no operation ran on
the device (the union of the profiler's device intervals), in %."""


def read(run):
    p = run.profile
    if p is None or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
