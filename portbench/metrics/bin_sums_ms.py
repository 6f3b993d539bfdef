"""The codebook gradient's per-bin sums: the device ms of the program's
``pasm.bin_sums`` spans over the train steps (``train.step`` spans)."""
from portbench.program_spans import device_ms_per


def read(run):
    return device_ms_per(run, "pasm.bin_sums", "train.step")
