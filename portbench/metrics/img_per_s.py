"""Images answered in the window over the window's seconds."""


def read(run):
    return run.counters["images"] / run.window_s
