"""K1's backward ``xᵀg`` products for the codebook gradient: the device ms
of the program's ``pasm.bwd_xg`` spans over the train steps (``train.step``
spans)."""
from portbench.program_spans import device_ms_per


def read(run):
    return device_ms_per(run, "pasm.bwd_xg", "train.step")
