"""Prompt tokens prefilled plus tokens generated in the window, over the
window's seconds."""


def read(run):
    return run.counters["tokens"] / run.window_s
