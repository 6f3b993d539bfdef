"""Training tokens of the steps completed in the window over the window's
seconds (the window ends with the step in flight at ``--seconds``)."""


def read(run):
    return run.counters["tokens"] / run.window_s
