"""A chunk's copy of images to the device: the mean device ms of the
program's ``batcher.h2d`` spans."""
from portbench.program_spans import device_ms_per


def read(run):
    return device_ms_per(run, "batcher.h2d", "batcher.h2d")
